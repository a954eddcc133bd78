"""The BGV slice of troy_tpu_torch against troy_tpu, on the CPU.

BGV at n = 1024 (q = {60,40,40,60}) and n = 4096 (q = {60,40,40,40,60}),
t = PlainModulus.batching(n, 20), SecurityLevel.none, and the t = 59-bit
case of troy's timing harness (n = 1024, q = {60,40,40,40,40,60}: t above
every 40-bit prime, where the plain lift and the exact conversion take
their Barrett branches): the same seeded inputs go through the JAX package
and the port, host sampling on both sides. Keys, ciphertexts, correction
factors, decrypted words and noise budgets are compared word for word
(tolerance 0), and so are the plain versions of kernels X (exact_convert,
decrypt_mod_t), K'-BGV (mod_t_and_divide_q_last_ntt, the key switch's
divide) and G' (plain_lift) against the JAX package's functions.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import troy_tpu as J
from troy_tpu import evaluator as jev
from troy_tpu import prng as jprng
from troy_tpu.ops import poly as jpoly
from troy_tpu.ops import rns as jrns

import troy_tpu_torch as P
from troy_tpu_torch import evaluator as pev
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.ops import poly, rns

torch.set_num_threads(1)

SEED = 4242
CONFIGS = {"n1024": (1024, [60, 40, 40, 60], 20),
           "n4096": (4096, [60, 40, 40, 40, 60], 20),
           "t59": (1024, [60, 40, 40, 40, 40, 60], 59)}


def _ctx(mod, name, scheme="bgv"):
    n, bits, t_bits = CONFIGS[name]
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(mod.CoeffModulus.create(n, bits)),
        plain_modulus=mod.PlainModulus.batching(n, t_bits))
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)


def _np(x):
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _stack(mod, name, scheme="bgv"):
    """Context, seeded keys (relin; Galois for steps 1, -1 and the row
    swap), encoder, evaluator, decryptor and encryptor of one package."""
    prng = tprng if mod is P else jprng
    ctx = _ctx(mod, name, scheme)
    kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                          host_sampling=True)
    enc = mod.Encryptor(ctx, secret_key=kg.secret_key,
                        seed=prng.seed_from_uint64(SEED + 1),
                        host_sampling=True)
    return {"ctx": ctx, "kg": kg, "rlk": kg.create_relin_keys(),
            "be": mod.BatchEncoder(ctx), "ev": mod.Evaluator(ctx),
            "dec": mod.Decryptor(ctx, kg.secret_key), "enc": enc}


@pytest.fixture(scope="module", params=["n1024", "n4096"])
def pair(request):
    """Both packages' BGV stacks, with three encrypted slot vectors."""
    name = request.param
    n = CONFIGS[name][0]
    out = {}
    for mod in (J, P):
        st = _stack(mod, name)
        st["gk"] = st["kg"].create_galois_keys(steps=[1, -1, 0])
        t = int(st["ctx"].first_context_data.plain_modulus)
        rng = np.random.default_rng(SEED)
        st["vals"] = [rng.integers(0, t, n, dtype=np.uint64)
                      for _ in range(3)]
        st["cts"] = [st["enc"].encrypt_symmetric(st["be"].encode(v))
                     for v in st["vals"]]
        st["t"] = t
        out[mod] = st
    return name, out


def _port_ct(jct):
    """The JAX package's ciphertext fed to the port (its words, level,
    form and correction factor)."""
    return interop.ciphertext(_np(jct.data), jct.level, jct.is_ntt_form,
                              "cpu", correction_factor=jct.correction_factor)


def _check_ct(got, want):
    assert got.level == want.level
    assert got.is_ntt_form == want.is_ntt_form
    assert got.correction_factor == want.correction_factor
    _same(got.data, want.data)


# --------------------------------------------------------------------------
# ops level: the plain versions of X, K'-BGV and G' against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["n1024", "t59"])
def levels(request):
    return request.param, _ctx(J, request.param), _ctx(P, request.param)


def test_exact_convert_and_decrypt_mod_t(levels):
    name, jctx, pctx = levels
    jcd, pcd = jctx.first_context_data, pctx.first_context_data
    rng = np.random.default_rng(1)
    x = np.stack([rng.integers(0, q, pcd.n, dtype=np.uint64)
                  for q in pcd.coeff_values])
    # every residue 0 and every residue q_i - 1 (alpha at its extremes)
    x[:, :2] = 0
    x[:, 2:4] = np.array(pcd.coeff_values, dtype=np.uint64)[:, None] - 1
    conv = pcd.exact_to_t
    assert conv.t == int(pcd.plain_modulus) and conv.k == pcd.limbs
    want = np.asarray(jrns.exact_convert(jnp.asarray(x),
                                         jcd.rns_tool.conv_q_to_t))
    _same(rns.exact_convert(interop.to_torch(x, "cpu"), conv), want)
    t = conv.t
    for cf in (1, 3, t - 2):
        inv = pow(cf, -1, t)
        want = jrns.decrypt_mod_t(jnp.asarray(x), jcd.rns_tool)
        if inv != 1:
            want = jrns.smul(want, inv, t)
        _same(rns.decrypt_mod_t(interop.to_torch(x, "cpu"), conv, inv), want)


def test_mod_t_and_divide_q_last_ntt(levels):
    name, jctx, pctx = levels
    for level in range(pctx.first_level, pctx.last_level):
        jcd, pcd = jctx.get_context_data(level), pctx.get_context_data(level)
        rng = np.random.default_rng(level)
        x = np.stack([np.stack([rng.integers(0, q, pcd.n, dtype=np.uint64)
                                for q in pcd.coeff_values])
                      for _ in range(2)])
        want = np.stack([np.asarray(jrns.mod_t_and_divide_q_last_ntt(
            jnp.asarray(x[c]), jcd.rns_tool, jcd.ntt)) for c in range(2)])
        xt = interop.to_torch(x, "cpu")
        _same(rns.mod_t_and_divide_q_last_ntt(xt, pcd.ntt,
                                              pcd.bgv_mod_switch_consts), want)
        _same(rns.mod_t_and_divide_q_last_ntt_plain(
            xt, pcd.ntt, pcd.bgv_mod_switch_consts), want)


def test_keyswitch_divide(levels):
    """The BGV key switch (digits, inner product and the t-corrected divide
    by the special prime) of a random NTT-form target under random key
    words, at every data level."""
    name, jctx, pctx = levels
    jkey, pkey = jctx.key_context_data, pctx.key_context_data
    kf = pkey.limbs
    rng = np.random.default_rng(7)
    key = np.stack([np.stack([np.stack([rng.integers(0, q, pkey.n,
                                                     dtype=np.uint64)
                                        for q in pkey.coeff_values])
                              for _ in range(2)])
                    for _ in range(kf - 1)])
    for level in range(pctx.first_level, pctx.last_level + 1):
        jcd, pcd = jctx.get_context_data(level), pctx.get_context_data(level)
        target = np.stack([rng.integers(0, q, pcd.n, dtype=np.uint64)
                           for q in pcd.coeff_values])
        want = jev._switch_key_core(jnp.asarray(target), jnp.asarray(key),
                                    jcd, jkey, True)
        got = pev._switch_key_core(interop.to_torch(target, "cpu"),
                                   interop.to_torch(key, "cpu"), pcd, pkey,
                                   ntt_form=True)
        _same(got, want)


def test_plain_lift(levels):
    """Both thresholds, and the BGV add_plain's m * cf mod t."""
    name, jctx, pctx = levels
    jcd, pcd = jctx.first_context_data, pctx.first_context_data
    t = int(pcd.plain_modulus)
    Q = pcd.total_coeff_modulus
    rng = np.random.default_rng(3)
    m = rng.integers(0, t, (2, pcd.n), dtype=np.uint64)
    m[:, :3] = [0, t - 1, (t + 1) >> 1]
    mt = interop.to_torch(m, "cpu")
    assert pcd.plain_upper_half_threshold == jcd.plain_upper_half_threshold
    assert pcd.plain_upper_half_increment == jcd.plain_upper_half_increment
    for threshold, cf in (((t + 1) >> 1, 1), (t, 1), ((t + 1) >> 1, 77),
                          ((t + 1) >> 1, t - 1)):
        jm = jnp.asarray(m) if cf == 1 else jrns.smul(jnp.asarray(m), cf, t)
        want = jpoly.plain_lift(jm, jcd.ntt, t, threshold, Q)
        _same(poly.plain_lift(mt, pcd.ntt, t, threshold, Q, cf), want)


# --------------------------------------------------------------------------
# the evaluator, encryptor and decryptor against the JAX package
# --------------------------------------------------------------------------

def test_keys(pair):
    _, both = pair
    j, p = both[J], both[P]
    _same(p["kg"].secret_key.data, j["kg"].secret_key.data)
    _same(p["rlk"].keys[2], j["rlk"].keys[2])
    assert sorted(p["gk"].keys) == sorted(j["gk"].keys)
    for elt in p["gk"].keys:
        _same(p["gk"].keys[elt], j["gk"].keys[elt])


def test_encrypt(pair):
    _, both = pair
    for pct, jct in zip(both[P]["cts"], both[J]["cts"]):
        assert pct.is_ntt_form and pct.correction_factor == 1
        _check_ct(pct, jct)


def test_multiply_square_relinearize(pair):
    _, both = pair
    j, p = both[J], both[P]
    ja, jb = j["cts"][:2]
    pa, pb = (_port_ct(c) for c in (ja, jb))
    jprod, pprod = j["ev"].multiply(ja, jb), p["ev"].multiply(pa, pb)
    _check_ct(pprod, jprod)
    _check_ct(p["ev"].square(pa), j["ev"].square(ja))
    _check_ct(p["ev"].relinearize(pprod, p["rlk"]),
              j["ev"].relinearize(jprod, j["rlk"]))


def test_mod_switch_and_correction_factors(pair):
    _, both = pair
    j, p = both[J], both[P]
    jrel = j["ev"].relinearize(j["ev"].multiply(*j["cts"][:2]), j["rlk"])
    prel = _port_ct(jrel)
    jms, pms = j["ev"].mod_switch_to_next(jrel), p["ev"].mod_switch_to_next(
        prel)
    assert pms.correction_factor != 1
    _check_ct(pms, jms)
    last = p["ctx"].last_level
    _check_ct(p["ev"].mod_switch_to(prel, last),
              j["ev"].mod_switch_to(jrel, last))
    # the product of two switched ciphertexts carries cf^2
    jsq = j["ev"].multiply(jms, jms)
    psq = p["ev"].multiply(pms, pms)
    _check_ct(psq, jsq)
    want = (j["vals"][0].astype(object) * j["vals"][1] % j["t"]) ** 2 % j["t"]
    np.testing.assert_array_equal(
        p["be"].decode(p["dec"].decrypt(psq)), want.astype(np.uint64))


def test_rotations(pair):
    _, both = pair
    j, p = both[J], both[P]
    jct = j["cts"][0]
    pct = _port_ct(jct)
    for steps in (1, -1):
        _check_ct(p["ev"].rotate_rows(pct, steps, p["gk"]),
                  j["ev"].rotate_rows(jct, steps, j["gk"]))
    _check_ct(p["ev"].rotate_columns(pct, p["gk"]),
              j["ev"].rotate_columns(jct, j["gk"]))
    rows = p["vals"][0].reshape(2, -1)
    np.testing.assert_array_equal(
        p["be"].decode(p["dec"].decrypt(p["ev"].rotate_rows(pct, 1,
                                                            p["gk"]))),
        np.roll(rows, -1, axis=1).reshape(-1))


def test_add_sub_negate_with_unequal_correction_factors(pair):
    _, both = pair
    j, p = both[J], both[P]
    jms = j["ev"].mod_switch_to_next(j["cts"][0])          # cf != 1
    jsq = j["ev"].multiply(jms, jms)                        # cf^2
    jc = j["ev"].mod_switch_to_next(j["cts"][2])
    pms, psq, pc = (_port_ct(c) for c in (jms, jsq, jc))
    for op in ("add", "sub"):
        want = getattr(j["ev"], op)(jsq, jc)
        got = getattr(p["ev"], op)(psq, pc)
        _check_ct(got, want)
    _check_ct(p["ev"].negate(pms), j["ev"].negate(jms))
    t = p["t"]
    a, c = (x.astype(object) for x in (p["vals"][0], p["vals"][2]))
    got = p["be"].decode(p["dec"].decrypt(p["ev"].add(psq, pc)))
    np.testing.assert_array_equal(got, ((a * a + c) % t).astype(np.uint64))
    got = p["be"].decode(p["dec"].decrypt(p["ev"].sub(psq, pc)))
    np.testing.assert_array_equal(got, ((a * a - c) % t).astype(np.uint64))


def test_plain_ops(pair):
    """add_plain / sub_plain at cf != 1, multiply_plain with a mod-t and an
    NTT-form plaintext, transform_plain_to_ntt."""
    _, both = pair
    j, p = both[J], both[P]
    jms = j["ev"].mod_switch_to_next(j["cts"][0])
    pms = _port_ct(jms)
    jpt, ppt = j["be"].encode(j["vals"][1]), p["be"].encode(p["vals"][1])
    _same(ppt.data, jpt.data)
    for op in ("add_plain", "sub_plain", "multiply_plain"):
        _check_ct(getattr(p["ev"], op)(pms, ppt), getattr(j["ev"], op)(jms,
                                                                       jpt))
    jn = j["ev"].transform_plain_to_ntt(jpt, jms.level)
    pn = p["ev"].transform_plain_to_ntt(ppt, pms.level)
    assert pn.is_ntt_form and pn.level == jn.level
    _same(pn.data, jn.data)
    _check_ct(p["ev"].multiply_plain(pms, pn), j["ev"].multiply_plain(jms,
                                                                      jn))
    t = p["t"]
    a, b = (x.astype(object) for x in (p["vals"][0], p["vals"][1]))
    dec = lambda ct: p["be"].decode(p["dec"].decrypt(ct))
    np.testing.assert_array_equal(dec(p["ev"].add_plain(pms, ppt)),
                                  ((a + b) % t).astype(np.uint64))
    np.testing.assert_array_equal(dec(p["ev"].sub_plain(pms, ppt)),
                                  ((a - b) % t).astype(np.uint64))
    np.testing.assert_array_equal(dec(p["ev"].multiply_plain(pms, ppt)),
                                  (a * b % t).astype(np.uint64))


def test_transforms_decrypt_and_noise_budget(pair):
    _, both = pair
    j, p = both[J], both[P]
    jct = j["cts"][2]
    pct = _port_ct(jct)
    jc, pc = j["ev"].transform_from_ntt(jct), p["ev"].transform_from_ntt(pct)
    _check_ct(pc, jc)
    _check_ct(p["ev"].transform_to_ntt(pc), jct)
    for ct_j, ct_p in ((jct, pct), (jc, pc)):
        _same(p["dec"].decrypt(ct_p).data, j["dec"].decrypt(ct_j).data)
    jms = j["ev"].mod_switch_to_next(jct)
    pms = _port_ct(jms)
    _same(p["dec"].decrypt(pms).data, j["dec"].decrypt(jms).data)
    np.testing.assert_array_equal(p["be"].decode(p["dec"].decrypt(pms)),
                                  p["vals"][2])
    for ct_j, ct_p in ((jct, pct), (jms, pms)):
        assert p["dec"].invariant_noise_budget(ct_p) == \
            j["dec"].invariant_noise_budget(ct_j) > 0


def test_balance_correction_factors_is_the_jax_packages():
    t = int(J.PlainModulus.batching(1024, 20))
    rng = np.random.default_rng(5)
    for f1, f2 in [(1, 1), (1, 2), (t - 1, 1)] + [
            tuple(int(x) for x in rng.integers(1, t, 2)) for _ in range(20)]:
        assert pev._balance_correction_factors(f1, f2, t) == \
            jev._balance_correction_factors(f1, f2, t)


# --------------------------------------------------------------------------
# t = 59 bits with 40-bit primes (troy's timing harness)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_t59_decrypt_level_chain(scheme):
    """encrypt, multiply, relinearize, mod switch and decrypt at a t above
    every 40-bit prime, word for word against the JAX package, and the
    decrypted slots right."""
    j, p = _stack(J, "t59", scheme), _stack(P, "t59", scheme)
    n = CONFIGS["t59"][0]
    t = int(p["ctx"].first_context_data.plain_modulus)
    assert t.bit_length() == 59
    assert all(q < t for q in p["ctx"].first_context_data.coeff_values[1:])
    rng = np.random.default_rng(59)
    vals = [rng.integers(0, t, n, dtype=np.uint64) for _ in range(2)]
    states = {}
    for mod, st in ((J, j), (P, p)):
        cts = [st["enc"].encrypt_symmetric(st["be"].encode(v)) for v in vals]
        rel = st["ev"].relinearize(st["ev"].multiply(*cts), st["rlk"])
        ms = st["ev"].mod_switch_to_next(rel)
        states[mod] = {"c1": cts[0], "rel": rel, "ms": ms,
                       "dec": st["dec"].decrypt(ms).data}
    for stage in ("c1", "rel", "ms"):
        _check_ct(states[P][stage], states[J][stage])
    _same(states[P]["dec"], states[J]["dec"])
    got = p["be"].decode(p["dec"].decrypt(states[P]["ms"]))
    want = vals[0].astype(object) * vals[1].astype(object) % t
    np.testing.assert_array_equal(got, want.astype(np.uint64))
