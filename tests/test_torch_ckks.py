"""The CKKS slice of troy_tpu_torch against troy_tpu, on the CPU.

Small CKKS parameters (tests/test_ckks.py: n = 64, q = {50,40,40,50},
SecurityLevel.none, and n = 1024 with five primes): the same seeded inputs
go through the JAX package and the port. Keys, ciphertexts and every
evaluator result are compared word for word; the port's encode is held to
the JAX package's host oracle within the bound of
tests/test_ckks_headline_vectors.py (|diff| <= 1 at <= 4 coefficient
positions: two correct double-precision transforms may split a rounding
tie differently), its decode to 1e-9. The plain versions of kernels O1-O3
and K' are compared with the JAX package's own functions on the same
inputs: O1 to 2^-44 max|x| (two FP64 transforms in different orders), O2,
O3 and K' exactly.
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng
from troy_tpu.ops import embedding as jemb
from troy_tpu.ops import rns as jrns

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.ops import embedding as emb
from troy_tpu_torch.ops import keyswitch, ntt, rns

torch.set_num_threads(1)

SEED = 777
SCALE = 2.0 ** 30
CONFIGS = {"n64": (64, [50, 40, 40, 50]),
           "n1024": (1024, [60, 40, 40, 40, 60])}


def _ctx(mod, name):
    n, bits = CONFIGS[name]
    parms = mod.EncryptionParameters(
        scheme=mod.SchemeType.ckks, poly_modulus_degree=n,
        coeff_modulus=tuple(mod.CoeffModulus.create(n, bits)))
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)


def _slots(rng, count):
    return rng.uniform(-1, 1, count) + 1j * rng.uniform(-1, 1, count)


def _tie_bound(ctx, got, want):
    """Coefficient-domain |diff| <= 1 at <= 4 positions (per limb)."""
    cd = ctx.first_context_data
    a, b = (interop.to_numpy(ntt.rns_ntt_inverse(
        interop.to_torch(x, "cpu"), cd.ntt)).astype(object)
        for x in (got, want))
    q = np.array(cd.coeff_values, dtype=object).reshape(-1, 1)
    d = (a - b) % q
    d = np.where(d > q // 2, d - q, d)
    assert int(np.max(np.abs(d))) <= 1
    assert int(np.sum(d != 0, axis=1).max()) <= 4


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """Both packages' contexts and seeded host-sampling keys: the JAX
    package's key set and the port's."""
    name = request.param
    out = {}
    for mod, prng in ((J, jprng), (P, tprng)):
        ctx = _ctx(mod, name)
        kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                              host_sampling=True)
        out[mod] = (ctx, kg, kg.create_relin_keys(),
                    kg.create_galois_keys(steps=[1, -1, 4, 0]))
    return name, out


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) \
        else interop.to_numpy(x)


def test_keys_are_the_jax_packages_words(pair):
    _, both = pair
    (_, jkg, jrlk, jgk), (_, pkg, prlk, pgk) = both[J], both[P]
    np.testing.assert_array_equal(_np(pkg.secret_key.data),
                                  _np(jkg.secret_key.data))
    np.testing.assert_array_equal(_np(prlk.keys[2]), _np(jrlk.keys[2]))
    assert sorted(pgk.keys) == sorted(jgk.keys)
    for elt in pgk.keys:
        np.testing.assert_array_equal(_np(pgk.keys[elt]), _np(jgk.keys[elt]))


def test_encode_and_decode(pair):
    _, both = pair
    jctx, pctx = both[J][0], both[P][0]
    rng = np.random.default_rng(1)
    jenc = J.CKKSEncoder(jctx, host=True)
    penc, phost = P.CKKSEncoder(pctx), P.CKKSEncoder(pctx, host=True)
    for count in (pctx.n // 2, 5):
        vals = _slots(rng, count)
        want = jenc.encode(vals, SCALE)
        got = penc.encode(vals, SCALE)
        assert got.level == want.level and got.scale == want.scale
        _tie_bound(pctx, _np(got.data), _np(want.data))
        np.testing.assert_array_equal(_np(phost.encode(vals, SCALE).data),
                                      _np(want.data))
        plain = interop.plaintext(_np(want.data), "cpu", want.level, True,
                                  SCALE)
        np.testing.assert_allclose(penc.decode(plain), jenc.decode(want),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(phost.decode(plain), jenc.decode(want),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(penc.decode(got)[:count], vals, atol=1e-6)


def test_encode_constant(pair):
    _, both = pair
    jctx, pctx = both[J][0], both[P][0]
    for value in (3.25, -1.5, 2.0 - 0.5j):
        want = J.CKKSEncoder(jctx, host=True).encode_constant(value, SCALE)
        got = P.CKKSEncoder(pctx).encode_constant(value, SCALE)
        if isinstance(value, complex):
            _tie_bound(pctx, _np(got.data), _np(want.data))
        else:
            np.testing.assert_array_equal(_np(got.data), _np(want.data))


def test_encode_refuses_values_too_large(pair):
    _, both = pair
    pctx = both[P][0]
    Q = pctx.first_context_data.total_coeff_modulus
    slots = pctx.n // 2
    enc = P.CKKSEncoder(pctx)
    with pytest.raises(ValueError, match="too large"):
        enc.encode(np.full(slots, 1.0), float(Q))         # the constant Q
    # the bound scale * max|v| fails, the exact magnitude (Q/n) passes
    enc.encode(np.eye(slots)[0], float(Q) / 4)


def _encrypt(mod, prng, ctx, kg, plain, seed):
    enc = mod.Encryptor(ctx, secret_key=kg.secret_key,
                        seed=prng.seed_from_uint64(seed), host_sampling=True)
    return enc.encrypt_symmetric(plain)


def test_chain_is_the_jax_packages_words(pair):
    """encrypt -> add/sub/negate -> multiply, square -> relinearize ->
    rescale, mod switch -> rotate_vector, complex_conjugate -> decrypt, on
    both packages from the JAX package's plaintext words."""
    _, both = pair
    jctx, jkg, jrlk, jgk = both[J]
    pctx, pkg, prlk, pgk = both[P]
    rng = np.random.default_rng(2)
    jenc = J.CKKSEncoder(jctx, host=True)
    jpl = [jenc.encode(_slots(rng, jctx.n // 2), SCALE) for _ in range(2)]
    ppl = [interop.plaintext(_np(p.data), "cpu", p.level, True, p.scale)
           for p in jpl]
    jc = [_encrypt(J, jprng, jctx, jkg, p, 30 + i) for i, p in enumerate(jpl)]
    pc = [_encrypt(P, tprng, pctx, pkg, p, 30 + i) for i, p in enumerate(ppl)]
    for a, b in zip(pc, jc):
        np.testing.assert_array_equal(_np(a.data), _np(b.data))
        assert a.is_ntt_form and a.scale == b.scale and a.level == b.level
    jev, pev = J.Evaluator(jctx), P.Evaluator(pctx)
    stages = {}

    def run(ev, c, rlk, gk):
        out = {"add": ev.add(*c), "sub": ev.sub(*c), "neg": ev.negate(c[0]),
               "prod": ev.multiply(*c), "sq": ev.square(c[0])}
        out["rel"] = ev.relinearize(out["prod"], rlk)
        out["rel_sq"] = ev.relinearize(out["sq"], rlk)
        out["rs"] = ev.rescale_to_next(out["rel"])
        out["ms"] = ev.mod_switch_to_next(c[0])
        out["rot"] = ev.rotate_vector(out["rel"], 1, gk)
        out["rot_rs"] = ev.rotate_vector(out["rs"], -1, gk)
        out["rot3"] = ev.rotate_vector(out["rs"], 3, gk)
        out["conj"] = ev.complex_conjugate(out["rs"], gk)
        return out

    stages[J] = run(jev, jc, jrlk, jgk)
    stages[P] = run(pev, pc, prlk, pgk)
    for name, want in stages[J].items():
        got = stages[P][name]
        np.testing.assert_array_equal(_np(got.data), _np(want.data),
                                      err_msg=name)
        assert got.level == want.level, name
        assert got.scale == pytest.approx(want.scale, rel=1e-15), name
    jdec = J.Decryptor(jctx, jkg.secret_key)
    pdec = P.Decryptor(pctx, pkg.secret_key)
    for name in ("rel", "rs", "conj", "prod"):
        got = pdec.decrypt(stages[P][name])
        want = jdec.decrypt(stages[J][name])
        np.testing.assert_array_equal(_np(got.data), _np(want.data),
                                      err_msg=name)
        assert (got.level, got.scale) == (want.level, want.scale)


def test_scale_mismatch_refused(pair):
    _, both = pair
    pctx, pkg, _, _ = both[P]
    enc = P.CKKSEncoder(pctx)
    a = _encrypt(P, tprng, pctx, pkg, enc.encode([1.0], SCALE), 1)
    b = _encrypt(P, tprng, pctx, pkg, enc.encode([1.0], 2 * SCALE), 2)
    with pytest.raises(ValueError, match="scales mismatch"):
        P.Evaluator(pctx).add(a, b)


# --------------------------------------------------------------------------
# the plain versions of O1-O3 and K' against the JAX package's functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_o1_plain_against_embed_inverse_and_forward(n):
    rng = np.random.default_rng(n)
    t = emb.make_embed_tables(n, "cpu")
    jt = jemb.make_embed_tables(n)
    vals = _slots(rng, n // 2) * 8
    v_re, v_im = jemb.scatter_slots(vals.real, vals.imag, jt)
    want = np.asarray(jemb.embed_inverse(v_re, v_im, jt))
    u = emb.embed_inverse_fft_plain(torch.from_numpy(vals), t)
    got = (u * t.untwist).real.numpy()
    assert np.abs(got - want).max() <= 2.0 ** -44 * np.abs(want).max()
    np.testing.assert_array_equal(
        emb.scatter_slots(torch.from_numpy(vals), t).numpy(),
        np.asarray(v_re) + 1j * np.asarray(v_im))
    coeffs = rng.uniform(-1, 1, n) * 2.0 ** 20
    w_re, w_im = jemb.embed_forward(coeffs, jt)
    want = np.asarray(w_re) + 1j * np.asarray(w_im)
    got = emb.embed_forward_plain(torch.from_numpy(coeffs), t).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -44 * np.abs(want).max()


def _level_tables(n, bits):
    q = tuple(int(m) for m in P.CoeffModulus.create(n, bits))
    return q, ntt.RnsNttTables.from_moduli(n, q, "cpu")


@pytest.mark.parametrize("log_mag", [10, 40, 62, 100, 200])
def test_o2_plain_against_round_to_rns_device(log_mag):
    """Exact rounding at any magnitude below Q/2, ties to even."""
    n = 1024
    q, t = _level_tables(n, [60, 50, 50, 50, 50, 60])
    rt = emb.make_rns_round_tables(t)
    jrt = jemb.make_rns_round_tables(q)
    tables = emb.make_embed_tables(n, "cpu")
    rng = np.random.default_rng(log_mag)
    coeffs = rng.uniform(-1, 1, n) * 2.0 ** log_mag
    coeffs[:8] = [0.5, -0.5, 1.5, -2.5, 3.5, 0.0, -0.0, 2.0 ** log_mag]
    # the JAX package rounds the same f64 values: Re(u * untwist) as O2
    # forms it, u_re ut_re - u_im ut_im, each product rounded (no fused
    # multiply-add); j = 0 keeps the ties above (untwist[0] = 1)
    u = torch.from_numpy(coeffs * np.asarray(tables.twist))
    un, ut = u.numpy(), np.asarray(tables.untwist)
    want_coeffs = un.real * ut.real - un.imag * ut.imag
    got = emb.untwist_round_to_rns_plain(u, tables.untwist, 1.0, rt)
    want = np.asarray(jemb.round_to_rns_device(want_coeffs, jrt))
    np.testing.assert_array_equal(interop.to_numpy(got), want)
    scaled = emb.untwist_round_to_rns_plain(u, tables.untwist, 2.0 ** 7, rt)
    want = np.asarray(jemb.round_to_rns_device(want_coeffs * 2.0 ** 7, jrt))
    np.testing.assert_array_equal(interop.to_numpy(scaled), want)


@pytest.mark.parametrize("bits", [[50, 40, 40], [60, 40, 40, 40, 40],
                                  [60] * 9])
def test_o3_plain_against_compose_centered_device(bits):
    n = 1024
    q, t = _level_tables(n, bits)
    rng = np.random.default_rng(len(bits))
    res = np.stack([rng.integers(0, qi, n, dtype=np.uint64) for qi in q])
    res[:, 0] = 0
    res[:, 1] = [qi - 1 for qi in q]                  # -1
    want = np.asarray(jemb.compose_centered_device(
        res, jemb.make_rns_round_tables(q)))
    rt = emb.make_rns_round_tables(t)
    got = emb.compose_centered_plain(interop.to_torch(res, "cpu"), rt)
    np.testing.assert_array_equal(got.numpy(), want)
    scaled = emb.compose_centered_plain(interop.to_torch(res, "cpu"), rt,
                                        2.0 ** -40)
    np.testing.assert_array_equal(scaled.numpy(), want * 2.0 ** -40)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kprime_plain_against_divide_and_round_q_last_ntt(name):
    jctx, pctx = _ctx(J, name), _ctx(P, name)
    for level in range(pctx.first_level, pctx.last_level):
        jcd, pcd = jctx.get_context_data(level), pctx.get_context_data(level)
        rng = np.random.default_rng(level)
        x = np.stack([np.stack([rng.integers(0, qi, pcd.n, dtype=np.uint64)
                                for qi in pcd.coeff_values])
                      for _ in range(2)])
        want = np.stack([np.asarray(jrns.divide_and_round_q_last_ntt(
            x[c], jcd.rns_tool, jcd.ntt)) for c in range(2)])
        xt = interop.to_torch(x, "cpu")
        got = rns.divide_and_round_q_last_ntt_plain(xt, pcd.ntt,
                                                    pcd.rescale_consts)
        np.testing.assert_array_equal(interop.to_numpy(got), want)
        np.testing.assert_array_equal(interop.to_numpy(
            rns.divide_and_round_q_last_ntt(xt, pcd.ntt, pcd.rescale_consts)),
            want)


def test_kprime_keyswitch_entry_with_accumulators():
    """The key switch's entry of K' against its definition: (x - round(x_k))
    / p, NTT domain, onto every accumulator width."""
    n = 64
    q, key = _level_tables(n, [60, 40, 40, 40, 40, 60])
    data = key.slice(0, 5)
    used = key.select(keyswitch.used_limbs(5, 6))
    consts = keyswitch.divide_round_consts(data, q[-1])
    rng = np.random.default_rng(9)
    x = interop.to_torch(np.stack([np.stack(
        [rng.integers(0, qi, n, dtype=np.uint64) for qi in used.values])
        for _ in range(2)]), "cpu")
    # the coefficient-domain divide of kernel F, moved into the NTT domain
    coeff = keyswitch.divide_round_last(ntt.rns_ntt_inverse(x, used), consts)
    want = ntt.rns_ntt_forward(coeff, data)
    for comps in (0, 1, 2):
        acc = interop.to_torch(np.stack([np.stack(
            [rng.integers(0, qi, n, dtype=np.uint64) for qi in q[:5]])
            for _ in range(comps)]), "cpu") if comps else None
        got = rns.divide_round_last_ntt(x, data, used.slice(5, 6), consts,
                                        acc)
        expect = want.clone()
        if acc is not None:
            expect[:comps] = (expect[:comps] + acc) % data.q.reshape(-1, 1)
        np.testing.assert_array_equal(interop.to_numpy(got),
                                      interop.to_numpy(expect))


def test_bgv_evaluation_still_raises():
    n = 64
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bgv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [40, 40])),
        plain_modulus=P.PlainModulus.batching(n, 17))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    ct = P.Ciphertext(data=torch.zeros((2, 1, n), dtype=torch.int64),
                      level=1, is_ntt_form=True)
    # BGV is ported now: what still raises is what BGV does not have (the
    # CKKS-only ops) and a BGV ciphertext out of NTT form where the op
    # needs it
    assert not P.Evaluator(ctx).add(ct, ct).data.any()
    with pytest.raises(ValueError, match="CKKS-only"):
        P.Evaluator(ctx).rescale_to_next(ct)
    with pytest.raises(ValueError, match="CKKS-only"):
        P.Evaluator(ctx).rotate_vector(ct, 1, P.GaloisKeys(keys={}))
    coeff = ct.replace(is_ntt_form=False)
    with pytest.raises(ValueError, match="expects NTT form"):
        P.Evaluator(ctx).multiply(coeff, coeff)
