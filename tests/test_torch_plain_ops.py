"""The plaintext-operand ops, the dedicated BFV square and the host loops
of troy_tpu_torch against troy_tpu, on the CPU.

BFV at n = 1024, q = {60,40,40,60}, t = PlainModulus.batching(n, 20), and
CKKS at n = 1024, q = {60,40,40,60}, scale 2^30, SecurityLevel.none: the
same seeded inputs (host-sampling keys and encryptions on both sides) go
through the JAX package and the port; every result is compared word for
word (tolerance 0) with its level, form and scale, and decrypted against
the expected slots (BFV exactly, CKKS within 1e-4).
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng

torch.set_num_threads(1)

SEED = 2718
N = 1024
BITS = [60, 40, 40, 60]
SCALE = 2.0 ** 30


def _np(x):
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _check(got, want):
    assert got.level == want.level and got.is_ntt_form == want.is_ntt_form
    assert got.scale == want.scale
    np.testing.assert_array_equal(_np(got.data), _np(want.data))


def _stack(mod, scheme):
    prng = tprng if mod is P else jprng
    kw = {"plain_modulus": mod.PlainModulus.batching(N, 20)} \
        if scheme == "bfv" else {}
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=N,
        coeff_modulus=tuple(mod.CoeffModulus.create(N, BITS)), **kw)
    on_cpu = {"device": "cpu"} if mod is P else {}
    ctx = mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)
    kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                          host_sampling=True)
    return {"ctx": ctx, "kg": kg, "rlk": kg.create_relin_keys(),
            "ev": mod.Evaluator(ctx),
            "dec": mod.Decryptor(ctx, kg.secret_key),
            "enc": mod.Encryptor(ctx, secret_key=kg.secret_key,
                                 seed=prng.seed_from_uint64(SEED + 1),
                                 host_sampling=True)}


@pytest.fixture(scope="module")
def bfv():
    rng = np.random.default_rng(SEED)
    out = {}
    for mod in (J, P):
        st = _stack(mod, "bfv")
        st["be"] = mod.BatchEncoder(st["ctx"])
        t = int(st["ctx"].first_context_data.plain_modulus)
        st["t"] = t
        out[mod] = st
    t = out[P]["t"]
    vals = [rng.integers(0, t, N, dtype=np.uint64) for _ in range(4)]
    for st in out.values():
        st["vals"] = vals
        st["cts"] = [st["enc"].encrypt_symmetric(st["be"].encode(v))
                     for v in vals[:3]]
        st["pt"] = st["be"].encode(vals[3])
    return out


@pytest.fixture(scope="module")
def ckks():
    rng = np.random.default_rng(SEED + 5)
    vals = [rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
            for _ in range(3)]
    out = {}
    for mod in (J, P):
        st = _stack(mod, "ckks")
        st["ce"] = (mod.CKKSEncoder(st["ctx"], host=True))
        # the JAX package's host oracle's words feed both, so the plain
        # ops start from the same plaintexts
        out[mod] = st
    jce = out[J]["ce"]
    plains = [jce.encode(v, SCALE) for v in vals]
    for mod, st in out.items():
        st["vals"] = vals
        st["pts"] = [p if mod is J else interop.plaintext(
            _np(p.data), "cpu", p.level, True, p.scale) for p in plains]
        st["cts"] = [st["enc"].encrypt_symmetric(p) for p in st["pts"][:2]]
    return out


def _bfv_decode(st, ct):
    return st["be"].decode(st["dec"].decrypt(ct))


@pytest.mark.parametrize("op", ["add_plain", "sub_plain", "multiply_plain"])
def test_bfv_plain_op(bfv, op):
    j, p = bfv[J], bfv[P]
    got = getattr(p["ev"], op)(p["cts"][0], p["pt"])
    _check(got, getattr(j["ev"], op)(j["cts"][0], j["pt"]))
    a, b = (v.astype(object) for v in (p["vals"][0], p["vals"][3]))
    t = p["t"]
    want = {"add_plain": a + b, "sub_plain": a - b,
            "multiply_plain": a * b}[op] % t
    np.testing.assert_array_equal(_bfv_decode(p, got),
                                  want.astype(np.uint64))


def test_bfv_multiply_plain_ntt_form(bfv):
    """A pre-transformed plaintext (transform_plain_to_ntt), on a
    coefficient-form and on an NTT-form ciphertext."""
    j, p = bfv[J], bfv[P]
    level = p["ctx"].first_level
    jn = j["ev"].transform_plain_to_ntt(j["pt"], level)
    pn = p["ev"].transform_plain_to_ntt(p["pt"], level)
    assert pn.is_ntt_form and pn.level == level
    np.testing.assert_array_equal(_np(pn.data), _np(jn.data))
    got = p["ev"].multiply_plain(p["cts"][0], pn)
    _check(got, j["ev"].multiply_plain(j["cts"][0], jn))
    _check(got, p["ev"].multiply_plain(p["cts"][0], p["pt"]))
    jt = j["ev"].transform_to_ntt(j["cts"][0])
    pt = p["ev"].transform_to_ntt(p["cts"][0])
    _check(pt, jt)
    _check(p["ev"].multiply_plain(pt, pn), j["ev"].multiply_plain(jt, jn))
    _check(p["ev"].transform_from_ntt(pt), j["ev"].transform_from_ntt(jt))


def test_bfv_square_is_one_lift(bfv):
    """The dedicated square gives the JAX package's _bfv_square words and
    multiply(ct, ct)'s, and lifts ct's components once."""
    from troy_tpu_torch.ops import rns
    j, p = bfv[J], bfv[P]
    calls = []
    lift = rns.behz_lift

    def counted(x, tool):
        calls.append(x.shape[0])
        return lift(x, tool)

    rns.behz_lift = counted
    try:
        got = p["ev"].square(p["cts"][0])
    finally:
        rns.behz_lift = lift
    assert calls == [2]
    _check(got, j["ev"].square(j["cts"][0]))
    _check(got, p["ev"].multiply(p["cts"][0], p["cts"][0]))
    a = p["vals"][0].astype(object)
    np.testing.assert_array_equal(
        _bfv_decode(p, p["ev"].relinearize(got, p["rlk"])),
        (a * a % p["t"]).astype(np.uint64))


def test_bfv_add_many_multiply_many_exponentiate(bfv):
    j, p = bfv[J], bfv[P]
    t = p["t"]
    a, b, c = (v.astype(object) for v in p["vals"][:3])
    got = p["ev"].add_many(p["cts"])
    _check(got, j["ev"].add_many(j["cts"]))
    np.testing.assert_array_equal(_bfv_decode(p, got),
                                  ((a + b + c) % t).astype(np.uint64))
    got = p["ev"].multiply_many(p["cts"], p["rlk"])
    _check(got, j["ev"].multiply_many(j["cts"], j["rlk"]))
    np.testing.assert_array_equal(_bfv_decode(p, got),
                                  (a * b * c % t).astype(np.uint64))
    got = p["ev"].exponentiate(p["cts"][1], 3, p["rlk"])
    _check(got, j["ev"].exponentiate(j["cts"][1], 3, j["rlk"]))
    np.testing.assert_array_equal(_bfv_decode(p, got),
                                  (b ** 3 % t).astype(np.uint64))
    with pytest.raises(ValueError):
        p["ev"].exponentiate(p["cts"][1], 0, p["rlk"])


def _ckks_decode(st, ct):
    return st["ce"].decode(st["dec"].decrypt(ct))


@pytest.mark.parametrize("op", ["add_plain", "sub_plain", "multiply_plain"])
def test_ckks_plain_op(ckks, op):
    j, p = ckks[J], ckks[P]
    got = getattr(p["ev"], op)(p["cts"][0], p["pts"][2])
    _check(got, getattr(j["ev"], op)(j["cts"][0], j["pts"][2]))
    a, b = p["vals"][0], p["vals"][2]
    want = {"add_plain": a + b, "sub_plain": a - b,
            "multiply_plain": a * b}[op]
    assert np.abs(_ckks_decode(p, got) - want).max() < 1e-4


def test_ckks_plain_op_checks(ckks):
    """A scale or level mismatch is refused as in the JAX package."""
    p = ckks[P]
    pt = p["pts"][2]
    wrong_scale = interop.plaintext(_np(pt.data), "cpu", pt.level, True,
                                    pt.scale * 2)
    with pytest.raises(ValueError, match="scale"):
        p["ev"].add_plain(p["cts"][0], wrong_scale)
    lower = p["ev"].mod_switch_plain_to_next(pt)
    with pytest.raises(ValueError, match="level"):
        p["ev"].multiply_plain(p["cts"][0], lower)


def test_ckks_mod_switch_plain_to(ckks):
    j, p = ckks[J], ckks[P]
    level = p["ctx"].last_level
    got = p["ev"].mod_switch_plain_to(p["pts"][2], level)
    want = j["ev"].mod_switch_plain_to(j["pts"][2], level)
    assert got.level == want.level == level and got.scale == want.scale
    np.testing.assert_array_equal(_np(got.data), _np(want.data))
    ct = p["ev"].mod_switch_to(p["cts"][0], level)
    jct = j["ev"].mod_switch_to(j["cts"][0], level)
    _check(p["ev"].add_plain(ct, got), j["ev"].add_plain(jct, want))
    assert np.abs(_ckks_decode(p, p["ev"].add_plain(ct, got))
                  - p["vals"][0] - p["vals"][2]).max() < 1e-4


def test_ckks_add_many_multiply_many(ckks):
    j, p = ckks[J], ckks[P]
    got = p["ev"].add_many(p["cts"])
    _check(got, j["ev"].add_many(j["cts"]))
    got = p["ev"].multiply_many(p["cts"], p["rlk"])
    _check(got, j["ev"].multiply_many(j["cts"], j["rlk"]))
    got = p["ev"].exponentiate(p["cts"][1], 2, p["rlk"])
    _check(got, j["ev"].exponentiate(j["cts"][1], 2, j["rlk"]))
    assert np.abs(_ckks_decode(p, got) - p["vals"][1] ** 2).max() < 1e-4
