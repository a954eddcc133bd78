"""troy's BGV headline chain in troy_tpu_torch against troy's C++ vectors,
on the CPU.

BGV n = 16384, q = {60,40,40,40,40,60}, t = PlainModulus.batching(n, 20)
(troy's test/timetest.cu:477-479): seeded host-sampling keygen (secret,
relin and Galois keys), encryption of the records' slot vectors, multiply,
relinearize, mod_switch_to_next (with its correction factor),
rotate_rows(1), decrypt and decode, each stage word for word against the
records of tests/data/ref_bgv_n16384_headline.bin (the chain chip_smoke.py
checks on the card). troy's host keeps BGV ciphertexts in coefficient
form, the port in NTT form: records go in and out through
transform_to_ntt / transform_from_ntt, as tests/test_bgv_headline_vectors.py
does. No JAX: the reference here is troy's own output.
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
SEED = 2027
DATA = pathlib.Path(__file__).parent / "data" / "ref_bgv_n16384_headline.bin"


def values(t):
    """The slot vectors troy's generator encrypted into c1 and c2."""
    i = np.arange(N, dtype=object)
    return [((3 * i + 11) % t).astype(np.uint64),
            ((i * i + 7) % t).astype(np.uint64)]


@pytest.fixture(scope="module")
def env():
    raw = interop.load_records(DATA)
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bgv, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS)),
        plain_modulus=P.PlainModulus.batching(N, 20))
    assert list(parms.coeff_values) == [int(x) for x in raw["q"]]
    assert int(parms.plain_modulus) == int(raw["t"][0])
    ctx = P.HeContext(parms, device="cpu")
    ev = P.Evaluator(ctx)

    def load(tag):
        """A record ciphertext (coefficient form, with its size and
        correction factor), in the port's NTT form."""
        size, is_ntt, cf = (int(v) for v in raw[tag + "_meta"][:3])
        ct = interop.ciphertext(raw[tag].reshape(size, -1, N),
                                ctx.first_level, bool(is_ntt), "cpu",
                                correction_factor=cf)
        return ct if ct.is_ntt_form else ev.transform_to_ntt(ct)

    def same(ct, tag):
        assert ct.is_ntt_form
        assert ct.correction_factor == int(raw[tag + "_meta"][2])
        np.testing.assert_array_equal(
            interop.words(ev.transform_from_ntt(ct)).reshape(-1), raw[tag])

    return raw, ctx, ev, load, same


@pytest.fixture(scope="module")
def keys(env):
    _, ctx, _, _, _ = env
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(SEED),
                        host_sampling=True)
    return kg, kg.create_relin_keys(), kg.create_galois_keys(steps=[1])


def test_keys(env, keys):
    raw = env[0]
    kg, rlk, gk = keys
    np.testing.assert_array_equal(interop.words(kg.secret_key).reshape(-1),
                                  raw["sk"])
    np.testing.assert_array_equal(interop.words(rlk)[2][0].reshape(-1),
                                  raw["rlk_0"])
    assert list(gk.keys) == [3]                       # 3^1 mod 2n
    np.testing.assert_array_equal(interop.words(gk)[3][0].reshape(-1),
                                  raw["gk_0"])


@pytest.mark.parametrize("index,tag", [(0, "c1"), (1, "c2")])
def test_encrypt(env, keys, index, tag):
    raw, ctx, _, _, same = env
    kg = keys[0]
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(SEED), host_sampling=True)
    vals = values(int(raw["t"][0]))[index]
    same(enc.encrypt_symmetric(P.BatchEncoder(ctx).encode(vals)), tag)


def test_multiply_relinearize_mod_switch_rotate(env, keys):
    _, _, ev, load, same = env
    _, rlk, gk = keys
    prod = ev.multiply(load("c1"), load("c2"))
    same(prod, "prod")
    rel = ev.relinearize(load("prod"), rlk)
    same(rel, "rel")
    ms = ev.mod_switch_to_next(load("rel"))
    assert ms.level == load("rel").level + 1 and ms.correction_factor != 1
    same(ms, "ms")
    same(ev.rotate_rows(load("rel"), 1, gk), "rot")


def test_decrypt_and_decode(env, keys):
    raw, ctx, ev, load, _ = env
    kg = keys[0]
    ms = ev.mod_switch_to_next(load("rel"))
    dec = P.Decryptor(ctx, kg.secret_key)
    got = P.BatchEncoder(ctx).decode(dec.decrypt(ms))
    np.testing.assert_array_equal(got, raw["dec_ms"])
    t = int(raw["t"][0])
    v1, v2 = values(t)
    np.testing.assert_array_equal(
        got, (v1.astype(object) * v2.astype(object) % t).astype(np.uint64))
