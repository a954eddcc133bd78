"""The headline chain of troy_tpu_torch against troy's C++ vectors, on the CPU.

BFV n = 16384, q = {60,40,40,40,40,60}, t = PlainModulus.batching(n, 20):
seeded host-sampling keygen (secret, relin and Galois keys) and encryption,
then multiply, relinearize, rotate_rows(1), mod_switch_to_next, decrypt and
the invariant noise budget, each stage compared word for word with the
records of tests/data/ref_bfv_n16384_headline.bin (the chain chip_smoke.py
checks on the card). No JAX: the reference here is troy's own output.
"""

import pathlib

import numpy as np
import pytest
import torch

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as rnd

torch.set_num_threads(2)

N = 16384
Q_BITS = [60, 40, 40, 40, 40, 60]
SEED = 2024
DATA = pathlib.Path(__file__).parent / "data" / "ref_bfv_n16384_headline.bin"


@pytest.fixture(scope="module")
def env():
    raw = interop.load_records(DATA)
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS)),
        plain_modulus=P.PlainModulus.batching(N, 20))
    assert list(parms.coeff_values) == [int(x) for x in raw["q"]]
    assert int(parms.plain_modulus) == int(raw["t"][0])
    return raw, P.HeContext(parms, device="cpu")


@pytest.fixture(scope="module")
def keys(env):
    _, ctx = env
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(SEED),
                        host_sampling=True)
    return kg, kg.create_relin_keys()


def _ct(raw, ctx, name):
    """A fixture ciphertext, with its size and NTT flag from '<name>_meta'."""
    size, is_ntt = int(raw[name + "_meta"][0]), bool(raw[name + "_meta"][1])
    return interop.ciphertext(raw[name].reshape(size, -1, N),
                              ctx.first_level, is_ntt, "cpu")


def test_secret_key_and_relin_key_row0(env, keys):
    raw, _ = env
    kg, rlk = keys
    np.testing.assert_array_equal(interop.words(kg.secret_key).reshape(-1),
                                  raw["sk"])
    np.testing.assert_array_equal(interop.words(rlk)[2][0].reshape(-1),
                                  raw["rlk_0"])


@pytest.mark.parametrize("tag", ["c1", "c2"])
def test_encrypt(env, keys, tag):
    """A fresh Encryptor per ciphertext: the reference's seeded factory
    replays the stream for each encryption."""
    raw, ctx = env
    kg, _ = keys
    t = int(raw["t"][0])
    i = np.arange(N, dtype=object)
    vals = (i * i + 3 * i + 1) % t if tag == "c1" else (7 * i + 2) % t
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(SEED), host_sampling=True)
    ct = enc.encrypt_symmetric(P.BatchEncoder(ctx).encode(
        vals.astype(np.uint64)))
    np.testing.assert_array_equal(interop.words(ct).reshape(-1), raw[tag])


def test_multiply(env):
    raw, ctx = env
    prod = P.Evaluator(ctx).multiply(_ct(raw, ctx, "c1"), _ct(raw, ctx, "c2"))
    np.testing.assert_array_equal(interop.words(prod).reshape(-1),
                                  raw["prod"])


def test_relinearize(env, keys):
    raw, ctx = env
    _, rlk = keys
    rel = P.Evaluator(ctx).relinearize(_ct(raw, ctx, "prod"), rlk)
    np.testing.assert_array_equal(interop.words(rel).reshape(-1), raw["rel"])


def test_decrypt_and_decode(env, keys):
    raw, ctx = env
    kg, _ = keys
    plain = P.Decryptor(ctx, kg.secret_key).decrypt(_ct(raw, ctx, "rel"))
    np.testing.assert_array_equal(P.BatchEncoder(ctx).decode(plain),
                                  raw["dec_rel"])


@pytest.fixture(scope="module")
def galois_keys(keys):
    """The key of rotation step 1, whose rows replay the seed stream."""
    kg, _ = keys
    return kg.create_galois_keys(steps=[1])


def test_galois_key_row0(env, galois_keys):
    raw, _ = env
    assert list(galois_keys.keys) == [3]        # 3^1 mod 2n
    np.testing.assert_array_equal(
        interop.words(galois_keys)[3][0].reshape(-1), raw["gk_0"])


def test_rotate_rows(env, galois_keys):
    raw, ctx = env
    rot = P.Evaluator(ctx).rotate_rows(_ct(raw, ctx, "rel"), 1, galois_keys)
    np.testing.assert_array_equal(interop.words(rot).reshape(-1), raw["rot"])


def test_mod_switch_to_next(env):
    raw, ctx = env
    ms = P.Evaluator(ctx).mod_switch_to_next(_ct(raw, ctx, "rel"))
    assert ms.level == ctx.first_level + 1
    np.testing.assert_array_equal(interop.words(ms).reshape(-1), raw["ms"])


def test_invariant_noise_budget(env, keys):
    raw, ctx = env
    kg, _ = keys
    dec = P.Decryptor(ctx, kg.secret_key)
    assert dec.invariant_noise_budget(_ct(raw, ctx, "rel")) == \
        int(raw["rel_budget"][0])
