"""troy_tpu_torch against troy's own host path at n = 64, on the CPU.

The twin of tests/test_reference_vectors.py: the same fixtures
(tests/data/ref_bfv_n64_seed42.txt, ref_bfv_n64_seed42_ops.txt and
ref_bgv_ckks_ops.txt, made by troy's pure-C++ CPU library; generators kept
beside them), the same tests and the same assertions, with troy's raw
secret keys, switching keys and ciphertexts loaded into the port's types
through ``troy_tpu_torch.interop``: prime generation, the batch encoder's
index map, the NTT layout, decryption, the BEHZ multiply, relinearize,
apply_galois and the mod switch, BGV's and CKKS's ops, the seeded secret
key, the CKKS encoder at 2^30, host-sampled encryption and keys, and the
noise budget. The ops run through tools/troy_vectors_torch.py, which
chip_smoke.py's phase 36 replays on the card. No JAX: the reference here is
troy's own output.
"""

import pathlib
import sys

import torch

import troy_tpu_torch as P

torch.set_num_threads(1)

N = 64
# tools/ holds the cases this file shares with chip_smoke.py's phase 36
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import troy_vectors_torch as tv  # noqa: E402


def test_parameter_generation_matches():
    """CoeffModulus.create / PlainModulus.batching give the primes troy
    generated (modulus.cpp:80-120, numth.cpp:261-284)."""
    vec = tv.seed42()
    assert [int(m) for m in P.CoeffModulus.create(N, [40, 40, 40])] \
        == vec["q"]
    assert int(P.PlainModulus.batching(N, 17)) == vec["t"]


def test_batch_encoder_matches_reference():
    """encode() yields troy's plaintext coefficients (batchencoder.cpp
    index map and inverse plain NTT)."""
    tv.verify(tv.batch_encoder("cpu"))


def test_decrypt_reference_ciphertext():
    """troy's secret key and symmetric ciphertext, decrypted and decoded
    bit-exact: the NTT layout, the ciphertext layout, the dot product and
    BFV's scale-and-round."""
    tv.verify(tv.decrypt_reference("cpu"))


def test_behz_multiply_bit_exact():
    """The BEHZ multiply of troy's two ciphertexts gives troy's product
    word for word (evaluator.cpp bfvMultiply: the same aux bases, m~
    Montgomery, fastFloor, fastbconvSk rounding)."""
    tv.verify(tv.behz_multiply("cpu"))


def test_relinearize_bit_exact():
    """The key switch with troy's relin keys gives troy's relinearized
    ciphertext (switchKeyInplace: lazy 128-bit sums, the divide by
    q_last)."""
    tv.verify(tv.relinearize("cpu"))


def test_apply_galois_bit_exact():
    tv.verify(tv.apply_galois("cpu"))


def test_mod_switch_bit_exact():
    tv.verify(tv.mod_switch("cpu"))


def test_bgv_ops_bit_exact():
    """troy's host BGV ciphertexts are in coefficient form, the port's in
    NTT form: the loads transform at the boundary."""
    tv.verify(tv.bgv_ops("cpu"))


def test_ckks_ops_bit_exact():
    tv.verify(tv.ckks_ops("cpu"))


def test_seeded_keygen_reproduces_reference_secret_key():
    """KeyGenerator with troy's seed gives troy's NTT-form secret key: the
    BLAKE2Xb stream and the ternary sampler's draw order (randomgen.cpp:188,
    rlwe.cpp:21-41, keygenerator.cpp generateSk)."""
    tv.verify(tv.seeded_secret_key("cpu"))


def test_ckks_encoder_bit_exact():
    """The canonical-embedding encode gives troy's plaintext words at scale
    2^30 (ckks.cpp encodeInternal)."""
    tv.verify(tv.ckks_encoder("cpu"))


def test_host_sampling_encryption_bit_exact_bfv():
    """Encryptor(host_sampling=True) with troy's seed and secret key gives
    troy's symmetric ciphertext (rlwe.cpp:110 encryptZeroSymmetric and the
    scaling-variant embed)."""
    tv.verify(tv.host_encryption_bfv("cpu"))


def test_host_sampling_encryption_bit_exact_bgv_ckks():
    """The same for BGV (seed 43) and CKKS (seed 44), a fresh Encryptor a
    ciphertext: troy's seeded factory replays the seed for every
    encryption (randomgen.h:419-427)."""
    tv.verify(tv.host_encryption_bgv_ckks("cpu"))


def test_host_sampling_keygen_reproduces_reference_keys():
    """KeyGenerator(host_sampling=True) with troy's seed gives troy's relin
    and Galois keys bit for bit (keygenerator.cpp:294-338)."""
    tv.verify(tv.host_keygen("cpu"))


def test_noise_budget_matches_reference():
    """invariant_noise_budget equals troy's on the same seeded ciphertext
    (decryptor.cpp:373-441: 58 bits fresh, 37 after a square)."""
    tv.verify(tv.noise_budget("cpu"))
