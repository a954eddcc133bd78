"""troy's CKKS headline chain in troy_tpu_torch against troy's C++ vectors,
on the CPU.

CKKS n = 16384, q = {60,40,40,40,40,60}, scale 2^40 (troy's
test/timetest.cu:278-331): seeded host-sampling keygen (secret, relin and
Galois keys), encode, encryption, multiply, relinearize, rescale_to_next,
rotate_vector(1), decrypt and decode, each stage compared with the records
of tests/data/ref_ckks_n16384_headline.bin (the chain chip_smoke.py checks
on the card). Word for word after encode; the encode itself within the
bound of tests/test_ckks_headline_vectors.py (two correct double-precision
transforms may split a rounding tie differently). No JAX: the reference
here is troy's own output.
"""

import pathlib
import struct

import numpy as np
import pytest
import torch

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as rnd
from troy_tpu_torch.ops import ntt as dntt

torch.set_num_threads(2)

N = 16384
Q_BITS = [60, 40, 40, 40, 40, 60]
SEED = 2025
SCALE = 2.0 ** 40
DATA = pathlib.Path(__file__).parent / "data" / "ref_ckks_n16384_headline.bin"


def values():
    """The slot vectors troy's generator encoded into p1 and p2."""
    i = np.arange(N // 2)
    return 0.001 * (i % 2000) - 1.0, 0.0005 * (i % 3000) + 0.25


def scale_of(raw, name) -> float:
    return struct.unpack("<d", int(raw[name + "_meta"][2])
                         .to_bytes(8, "little"))[0]


def record_ct(raw, ctx, name, device="cpu"):
    """A record ciphertext with its size, NTT flag and scale."""
    size, is_ntt = int(raw[name + "_meta"][0]), bool(raw[name + "_meta"][1])
    return interop.ciphertext(raw[name].reshape(size, -1, N),
                              ctx.first_level, is_ntt, device,
                              scale=scale_of(raw, name))


def tie_diffs(ctx, got: np.ndarray, want: np.ndarray):
    """(max |diff|, positions that differ) of two NTT-form plaintexts of the
    first data level, compared in the coefficient domain, centred."""
    cd = ctx.first_context_data
    t = dntt.RnsNttTables.from_moduli(N, cd.coeff_values, "cpu")
    a, b = (interop.to_numpy(dntt.rns_ntt_inverse(
        interop.to_torch(x.reshape(cd.limbs, N), "cpu"), t)).astype(object)
        for x in (got, want))
    q = np.array(cd.coeff_values, dtype=object).reshape(-1, 1)
    d = (a - b) % q
    d = np.where(d > q // 2, d - q, d)
    return int(np.max(np.abs(d))), int(np.sum(d[0] != 0))


@pytest.fixture(scope="module")
def env():
    raw = interop.load_records(DATA)
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.ckks, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS)))
    assert list(parms.coeff_values) == [int(x) for x in raw["q"]]
    return raw, P.HeContext(parms, device="cpu")


@pytest.fixture(scope="module")
def keys(env):
    _, ctx = env
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(SEED),
                        host_sampling=True)
    return kg, kg.create_relin_keys(), kg.create_galois_keys(steps=[1])


def test_keys(env, keys):
    raw, _ = env
    kg, rlk, gk = keys
    np.testing.assert_array_equal(interop.words(kg.secret_key).reshape(-1),
                                  raw["sk"])
    np.testing.assert_array_equal(interop.words(rlk)[2][0].reshape(-1),
                                  raw["rlk_0"])
    assert list(gk.keys) == [3]                       # 3^1 mod 2n
    np.testing.assert_array_equal(interop.words(gk)[3][0].reshape(-1),
                                  raw["gk_0"])


@pytest.mark.parametrize("tag", ["p1", "p2"])
def test_encode(env, tag):
    """|diff| <= 1 at <= 4 positions of the coefficients, against troy's."""
    raw, ctx = env
    vals = values()[0 if tag == "p1" else 1]
    pt = P.CKKSEncoder(ctx).encode(vals, SCALE)
    assert pt.scale == SCALE and pt.level == ctx.first_level
    worst, count = tie_diffs(ctx, interop.words(pt), raw[tag])
    assert worst <= 1 and count <= 4, (worst, count)


@pytest.mark.parametrize("ptag,ctag", [("p1", "c1"), ("p2", "c2")])
def test_encrypt(env, keys, ptag, ctag):
    """The records' own plaintext words, encrypted by a fresh Encryptor."""
    raw, ctx = env
    kg, _, _ = keys
    plain = interop.plaintext(raw[ptag].reshape(-1, N), "cpu",
                              ctx.first_level, True, SCALE)
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(SEED), host_sampling=True)
    ct = enc.encrypt_symmetric(plain)
    assert ct.is_ntt_form and ct.scale == SCALE
    np.testing.assert_array_equal(interop.words(ct).reshape(-1), raw[ctag])


def test_multiply_relinearize_rescale_rotate(env, keys):
    raw, ctx = env
    _, rlk, gk = keys
    ev = P.Evaluator(ctx)
    prod = ev.multiply(record_ct(raw, ctx, "c1"), record_ct(raw, ctx, "c2"))
    np.testing.assert_array_equal(interop.words(prod).reshape(-1),
                                  raw["prod"])
    rel = ev.relinearize(record_ct(raw, ctx, "prod"), rlk)
    np.testing.assert_array_equal(interop.words(rel).reshape(-1), raw["rel"])
    rs = ev.rescale_to_next(record_ct(raw, ctx, "rel"))
    np.testing.assert_array_equal(interop.words(rs).reshape(-1), raw["rs"])
    want = scale_of(raw, "rs")
    assert abs(rs.scale - want) <= abs(want) * 1e-12
    rot = ev.rotate_vector(record_ct(raw, ctx, "rel"), 1, gk)
    np.testing.assert_array_equal(interop.words(rot).reshape(-1), raw["rot"])


def test_decrypt_and_decode(env, keys):
    raw, ctx = env
    kg, _, _ = keys
    v1, v2 = values()
    plain = P.Decryptor(ctx, kg.secret_key).decrypt(record_ct(raw, ctx, "rel"))
    got = P.CKKSEncoder(ctx).decode(plain)
    np.testing.assert_allclose(np.real(got), v1 * v2, atol=1e-6)
