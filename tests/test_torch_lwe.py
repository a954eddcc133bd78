"""The negacyclic shift and the LWE ops of troy_tpu_torch against troy_tpu.

At n = 64 and 1024 (SecurityLevel.none), BFV, CKKS and BGV: seeded
host-sampling keys (the automorphism set 2^i + 1) and encryptions through
both packages, then ``negacyclic_shift`` at shifts {0, 1, n-1, n, n+3,
2n-1}, ``extract_lwe`` and ``extract_lwe_many`` (CKKS from NTT form),
``assemble_lwe``, ``divide_by_poly_modulus_degree``, and for BFV and CKKS
``field_trace`` and ``pack_lwe_ciphertexts`` of 1, 3, 4 and 7 samples, word
for word; the NTT-form BGV ``field_trace`` word for word. troy_tpu's BGV
packing folds in the coefficient domain with a key switch that returns NTT
form (troy_tpu/evaluator.py:345-348) and decrypts wrong: the port's BGV
packing and coefficient-form trace are held by decryption instead. Then the
plain versions of kernels N1 (shift, extract, assemble), N2 (the pack-tree
prepare) and K'' (``mod_t_and_divide_q_last``) against troy_tpu's
functions. Both packages run on the CPU, the JAX package as its own tests
run it; the port's wrappers run the kernels' plain versions.
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
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.ops import poly as tpoly
from troy_tpu_torch.ops import rns as trns

torch.set_num_threads(1)

SEED = 2026
NS = [64, 1024]
SCHEMES = ["bfv", "ckks", "bgv"]
COUNTS = [1, 3, 4, 7]
CKKS_SCALE = 2.0 ** 30


def shifts(n):
    return [0, 1, n - 1, n, n + 3, 2 * n - 1]


def terms(n):
    return [0, 1, 5, n // 2 + 3, n - 1]


def _context(mod, scheme, n):
    kw = {} if scheme == "ckks" else {
        "plain_modulus": mod.PlainModulus.batching(n, 20)}
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(mod.CoeffModulus.create(n, [40, 40, 40, 40])),
        **kw)
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)


def _run(mod, prng, scheme, n):
    """Every op of this file through one package: {stage: words} and the
    port's objects for the decryption checks."""
    ctx = _context(mod, scheme, n)
    kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                          host_sampling=True)
    ak = kg.create_automorphism_keys()
    enc = mod.Encryptor(ctx, secret_key=kg.secret_key,
                        seed=prng.seed_from_uint64(SEED + 1),
                        host_sampling=True)
    ev = mod.Evaluator(ctx)
    w = (lambda x: np.asarray(x)) if mod is J else P.to_numpy
    rng = np.random.default_rng(SEED + n)
    if scheme == "ckks":
        ce = mod.CKKSEncoder(ctx)
        vals = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
        ntt_ct = enc.encrypt_symmetric(ce.encode(vals, CKKS_SCALE))
        coeffs = None
    else:
        be = mod.BatchEncoder(ctx)
        t = be.plain_modulus
        coeffs = rng.integers(0, t, n, dtype=np.uint64)
        ntt_ct = enc.encrypt_symmetric(be.encode_polynomial(coeffs))
        if not ntt_ct.is_ntt_form:
            ntt_ct = ev.transform_to_ntt(ntt_ct)
    ct = ev.transform_from_ntt(ntt_ct)
    out = {"ct": w(ct.data)}
    for s in shifts(n):
        out[f"shift{s}"] = w(ev.negacyclic_shift(ct, s).data)
    ts = terms(n)
    lwes = ev.extract_lwe_many(ntt_ct if scheme == "ckks" else ct, ts)
    for i, term in enumerate(ts):
        one = ev.extract_lwe(ct, term)
        out[f"extract{term}"] = (w(one.c1), w(one.c0))
        out[f"extract_many{term}"] = (w(lwes[i].c1), w(lwes[i].c0))
    out["assemble0"] = w(ev.assemble_lwe(lwes[1]).data)
    out["assemble7"] = w(ev.assemble_lwe(lwes[2], 7).data)
    out["divide"] = w(ev.divide_by_poly_modulus_degree(ct).data)
    out["divide3"] = w(ev.divide_by_poly_modulus_degree(ct, 3).data)
    trace_ct = ntt_ct if scheme != "bfv" else ct
    packed = {}
    for logn in (0, 2):
        out[f"trace{logn}"] = w(ev.field_trace(trace_ct, ak, logn).data)
    many = lwes + ev.extract_lwe_many(ct, [2, 9, 11])
    for count in COUNTS:
        packed[count] = ev.pack_lwe_ciphertexts(many[:count], ak)
        out[f"pack{count}"] = w(packed[count].data)
    port = None
    if mod is P:
        dec = P.Decryptor(ctx, kg.secret_key)
        port = {"ctx": ctx, "ev": ev, "dec": dec, "ak": ak, "ct": ct,
                "coeffs": coeffs, "packed": packed,
                "terms": ts + [2, 9, 11], "lwes": many,
                "encoder": ce if scheme == "ckks" else be}
    return out, port


_RUNS = {}


def runs(scheme, n):
    if (scheme, n) not in _RUNS:
        _RUNS[(scheme, n)] = (_run(J, jprng, scheme, n)[0],
                              *_run(P, tprng, scheme, n))
    return _RUNS[(scheme, n)]


def _stages(scheme, n):
    stages = (["ct", "assemble0", "assemble7", "divide", "divide3"]
              + [f"shift{s}" for s in shifts(n)]
              + [f"extract{t}" for t in terms(n)]
              + [f"extract_many{t}" for t in terms(n)])
    if scheme != "bgv":
        stages += [f"trace{logn}" for logn in (0, 2)]
        stages += [f"pack{c}" for c in COUNTS]
    else:
        stages += ["trace0", "trace2"]          # NTT form: word-equal
    return stages


@pytest.mark.parametrize("scheme,n,stage", [
    (s, n, st) for s in SCHEMES for n in NS for st in _stages(s, n)])
def test_words(scheme, n, stage):
    jax_out, port_out, _ = runs(scheme, n)
    want, got = jax_out[stage], port_out[stage]
    if isinstance(want, tuple):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scheme,n", [(s, n) for s in ("bfv", "bgv")
                                      for n in NS])
def test_pack_decrypts_to_the_extracted_terms(scheme, n):
    """Sample i lands at coefficient i n / 2^l, every other coefficient
    0: for BGV, where troy_tpu's packing decrypts wrong, too."""
    _, _, port = runs(scheme, n)
    be, dec = port["encoder"], port["dec"]
    for count, ct in port["packed"].items():
        got = be.decode_polynomial(dec.decrypt(ct))
        l = max(count - 1, 0).bit_length()
        want = np.zeros(n, dtype=np.uint64)
        want[::n >> l][:count] = port["coeffs"][port["terms"][:count]]
        np.testing.assert_array_equal(got, want, err_msg=f"count {count}")


@pytest.mark.parametrize("n", NS)
def test_bgv_coefficient_trace_decrypts(n):
    """The trace of a coefficient-form BGV ciphertext (the packing's last
    step) keeps coefficient 0 times n and annihilates the rest."""
    _, _, port = runs("bgv", n)
    ev, be, dec = port["ev"], port["encoder"], port["dec"]
    for logn in (0, 2):
        got = be.decode_polynomial(dec.decrypt(
            ev.field_trace(port["ct"], port["ak"], logn)))
        want = np.zeros(n, dtype=object)
        keep = np.arange(0, n, n >> logn)
        want[keep] = (port["coeffs"][keep].astype(object) * (n >> logn)
                      % be.plain_modulus)
        np.testing.assert_array_equal(got, want.astype(np.uint64))


def test_lwe_checks():
    _, _, port = runs("bfv", 64)
    ev, ct = port["ev"], port["ct"]
    with pytest.raises(ValueError, match="out of"):
        ev.extract_lwe_many(ct, [0, 64])
    with pytest.raises(ValueError, match="out of"):
        ev.extract_lwe(ct, -1)
    with pytest.raises(ValueError, match="size-2"):
        ev.extract_lwe(ct.replace(data=torch.cat([ct.data, ct.data[:1]])), 0)
    with pytest.raises(ValueError, match="no LWE"):
        ev.pack_lwe_ciphertexts([], port["ak"])
    with pytest.raises(ValueError, match="not present"):
        ev.pack_lwe_ciphertexts(port["lwes"][:2], P.GaloisKeys(keys={}))
    with pytest.raises(ValueError, match="coefficient form"):
        ev.negacyclic_shift(ev.transform_to_ntt(ct), 1)


# --------------------------------------------------------------------------
# the plain versions of N1, N2 and K'' against troy_tpu's functions
# --------------------------------------------------------------------------

def _tables(scheme, n):
    jctx, pctx = _context(J, scheme, n), _context(P, scheme, n)
    return jctx.first_context_data, pctx.first_context_data


def _uniform(rng, moduli, lead, n):
    cols = [rng.integers(0, q, size=lead + (1, n), dtype=np.uint64)
            for q in moduli]
    return np.concatenate(cols, axis=-2)


@pytest.mark.parametrize("n", NS)
def test_shift_plain_against_troy_tpu(n):
    jcd, pcd = _tables("bfv", n)
    rng = np.random.default_rng(n)
    x = _uniform(rng, jcd.coeff_values, (2,), n)
    x[:, :, :3] = 0                                 # 0 stays 0
    xt = P.to_torch(x, "cpu")
    for s in shifts(n) + [5 * n + 2, -3]:
        want = np.asarray(jpoly.negacyclic_shift(jnp.asarray(x), s, jcd.ntt))
        np.testing.assert_array_equal(
            P.to_numpy(tpoly.negacyclic_shift_plain(xt, s, pcd.ntt)), want,
            err_msg=f"shift {s}")
    # one shift per row, and a per-limb scalar after it
    per_row = shifts(n)
    xs = _uniform(rng, jcd.coeff_values, (len(per_row),), n)
    got = tpoly.negacyclic_shift_plain(
        P.to_torch(xs, "cpu"), torch.tensor(per_row), pcd.ntt, [3, 5, 7])
    for i, s in enumerate(per_row):
        want = jpoly.rns_scalar_mul(
            jpoly.negacyclic_shift(jnp.asarray(xs[i]), s, jcd.ntt), [3, 5, 7],
            jcd.ntt)
        np.testing.assert_array_equal(P.to_numpy(got[i]), np.asarray(want))


@pytest.mark.parametrize("n", NS)
def test_extract_assemble_plain_against_troy_tpu(n):
    jcd, pcd = _tables("bfv", n)
    rng = np.random.default_rng(n + 1)
    data = _uniform(rng, jcd.coeff_values, (2,), n)
    ts = np.array(terms(n), dtype=np.int32)
    jc1, jc0 = jev._extract_lwe_many_core(jnp.asarray(data), jnp.asarray(ts),
                                          jcd)
    sh = torch.tensor([0 if t == 0 else 2 * n - t for t in terms(n)])
    c1, c0 = tpoly.extract_lwe_many_plain(P.to_torch(data, "cpu"), sh,
                                          pcd.ntt)
    np.testing.assert_array_equal(P.to_numpy(c1), np.asarray(jc1))
    np.testing.assert_array_equal(P.to_numpy(c0), np.asarray(jc0))
    want = np.asarray(jev._pack_assemble_core(jc1, jc0, jcd))
    inv_n = [pow(n, -1, q) for q in jcd.coeff_values]
    got = tpoly.assemble_lwe_plain(c1, c0, 0, pcd.ntt, inv_n)
    np.testing.assert_array_equal(P.to_numpy(got), want)


@pytest.mark.parametrize("n", NS)
def test_pack_prepare_plain_against_troy_tpu(n):
    jcd, pcd = _tables("bfv", n)
    rng = np.random.default_rng(n + 2)
    cur = _uniform(rng, jcd.coeff_values, (8, 2), n)
    for shift in (n // 2, n // 4, 1):
        even, folded = jev._pack_fold_prepare(jnp.asarray(cur), jcd, shift,
                                              False)
        got = tpoly.pack_fold_prepare_plain(P.to_torch(cur, "cpu"), shift,
                                            pcd.ntt)
        np.testing.assert_array_equal(P.to_numpy(got[0]), np.asarray(even))
        np.testing.assert_array_equal(P.to_numpy(got[1]), np.asarray(folded))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("t_bits", [20, 35])
def test_mod_t_and_divide_q_last_against_troy_tpu(n, t_bits):
    """K'' with the divisor q_last: troy_tpu.ops.rns.mod_t_and_divide_q_last
    word for word, edge words 0 and q - 1 included."""
    ctxs = {}
    for mod in (J, P):
        parms = mod.EncryptionParameters(
            scheme=mod.SchemeType.bgv, poly_modulus_degree=n,
            coeff_modulus=tuple(mod.CoeffModulus.create(n, [50, 40, 45, 50])),
            plain_modulus=mod.PlainModulus.batching(n, t_bits))
        on_cpu = {"device": "cpu"} if mod is P else {}
        ctxs[mod] = mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                  **on_cpu).first_context_data
    jcd, pcd = ctxs[J], ctxs[P]
    rng = np.random.default_rng(n + t_bits)
    x = _uniform(rng, jcd.coeff_values, (3,), n)
    x[0, :, :2] = 0
    x[1, :, :2] = np.array(jcd.coeff_values, dtype=np.uint64)[:, None] - 1
    got = trns.mod_t_and_divide_q_last(P.to_torch(x, "cpu"), pcd.ntt,
                                       pcd.bgv_mod_switch_consts)
    for i in range(3):
        want = jrns.mod_t_and_divide_q_last(jnp.asarray(x[i]), jcd.rns_tool)
        np.testing.assert_array_equal(P.to_numpy(got[i]), np.asarray(want))
