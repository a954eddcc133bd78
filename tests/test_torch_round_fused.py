"""The CKKS encode's exact rounding folded into kernel A's first forward
pass (AO2p, troy_tpu_torch/ops/embedding.py ``rns_ntt_forward_round``,
csrc/ntt.cu ``troy_ntt_forward_round``) against troy_tpu, word for word
(tolerance 0), on the CPU.

CKKS contexts at n = 1024 and 2048 over q = {60,40,40,60}; slot values
and real coefficients from numpy seeds:
  * the port's ``CKKSEncoder.encode`` (O1, then one AO2p call on A's
    route) against troy_tpu's device encode, with scale * max|v| < 2^44,
    where troy_tpu rounds exactly;
  * the rounding and transform from the port's own FFT output against
    troy_tpu/ops/embedding.py:425 ``round_to_rns_device`` and troy_tpu's
    forward transform of the same f64 values (Re(u * untwist) as O2 forms
    it), at scales 2^30 to 2^100 (``round_to_rns_device`` rounds exactly
    at any magnitude; from the same u, since O1 and troy_tpu's transform
    may round a coefficient differently near a tie);
  * ``encode_polynomial`` at the first data level and the last;
  * above 2^44 (2^55 and 2^100) the fused wrapper's plain version against
    O2's plain version then A's, as tests/test_torch_ckks.py holds O2;
  * the route: AO2p on A's tables; O2 and J with ``use_mxu=True``, both
    giving the same words;
  * the wrapper's refusals (J's tables, a pointwise view, a wrong length,
    a wrong dtype, another base's round tables, a tensor off the CPU);
  * a plain-torch emulation of the fused first pass's addressing
    (csrc/ntt.cu's plan, block, line and word maps, read from the source
    by tests/test_torch_divide_fused.py's helpers): which source word each
    output word rounds, into which limb, with RoundLayout's constants,
    held to the plain version at the compiled geometries and the run-time
    ones. The kernel cannot run here; this guards its addressing on the
    CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu.ops import embedding as jemb
from troy_tpu.ops import ntt as jntt
from test_torch_divide_fused import _pass_words, _plan

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch.ops import embedding as emb
from troy_tpu_torch.ops import ntt
from troy_tpu_torch.ops import u64ops as u

torch.set_num_threads(2)

SEED = 2020
BITS = [60, 40, 40, 60]

_CTX = {}


def _ctxs(n, use_mxu=False):
    """(port context, troy_tpu context): CKKS at n over BITS; the port on
    J's tables with ``use_mxu``."""
    key = (n, use_mxu)
    if key not in _CTX:
        out = []
        for mod in (P, J):
            parms = mod.EncryptionParameters(
                scheme=mod.SchemeType.ckks, poly_modulus_degree=n,
                coeff_modulus=tuple(mod.CoeffModulus.create(n, BITS)))
            on = ({"device": "cpu", "use_mxu": use_mxu} if mod is P
                  else {"use_mxu": False})
            out.append(mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                     **on))
        _CTX[key] = tuple(out)
    return _CTX[key]


def _slots(rng, count):
    return rng.uniform(-1, 1, count) + 1j * rng.uniform(-1, 1, count)


def _equal(port: torch.Tensor, ref) -> None:
    got, want = interop.to_numpy(port), np.asarray(ref)
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0, "words differ"


# --------------------------------------------------------------------------
# the encodes against troy_tpu
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("log_scale", [30, 40])
def test_encode_matches_troy_tpu(n, log_scale):
    pc, jc = _ctxs(n)
    rng = np.random.default_rng(SEED + n + log_scale)
    for count in (n // 2, 7):
        vals = _slots(rng, count)
        got = P.CKKSEncoder(pc).encode(vals, 2.0 ** log_scale)
        want = J.CKKSEncoder(jc).encode(vals, 2.0 ** log_scale)
        assert got.level == want.level and got.scale == want.scale
        _equal(got.data, want.data)


@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("log_scale", [30, 40, 43, 55, 100])
def test_rounding_stage_matches_troy_tpu(n, log_scale):
    """The fused call on the port's FFT output u (and the slot encode's
    untwist) against troy_tpu's exact rounding and forward transform of
    Re(u * untwist) * scale."""
    pc, jc = _ctxs(n)
    pd, jd = pc.first_context_data, jc.first_context_data
    tables = emb.make_embed_tables(n, "cpu")
    u_ = emb.embed_inverse_fft(torch.from_numpy(_slots(
        np.random.default_rng(SEED + log_scale), n // 2)), tables)
    u_[:4] = torch.tensor([0.5, -2.5, 3.5, 0.0], dtype=torch.complex128) \
        * 2.0 ** -log_scale                 # ties, untwist[0] = 1
    scale = 2.0 ** log_scale
    rt = emb.make_rns_round_tables(pd.ntt)
    got = emb.rns_ntt_forward_round(u_, tables.untwist, scale, rt, pd.ntt)
    un, ut = u_.numpy(), tables.untwist.numpy()
    re = un.real * ut.real - un.imag * ut.imag
    jrt = jemb.make_rns_round_tables(tuple(pd.coeff_values))
    want = jntt.rns_ntt_forward(jemb.round_to_rns_device(re * scale, jrt),
                                jd.ntt)
    _equal(got, want)


@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("level", ["first", "last"])
def test_encode_polynomial_matches_troy_tpu(n, level):
    pc, jc = _ctxs(n)
    lv = pc.first_level if level == "first" else pc.last_level
    rng = np.random.default_rng(SEED + n + len(level))
    coeffs = rng.uniform(-1, 1, n)
    coeffs[:4] = [0.5, -2.5, 3.5, -0.0]
    for log_scale in (0, 30, 40):
        for count in (n, 9):
            got = P.CKKSEncoder(pc).encode_polynomial(
                coeffs[:count], 2.0 ** log_scale, lv)
            want = J.CKKSEncoder(jc).encode_polynomial(
                coeffs[:count], 2.0 ** log_scale, lv)
            assert got.level == want.level
            _equal(got.data, want.data)


@pytest.mark.parametrize("log_scale", [55, 100])
@pytest.mark.parametrize("twisted", [True, False])
def test_fused_wrapper_is_the_rounding_then_the_transform(log_scale,
                                                          twisted):
    pc, _ = _ctxs(1024)
    pd = pc.first_context_data
    tables = emb.make_embed_tables(pd.n, "cpu")
    rt = emb.make_rns_round_tables(pd.ntt)
    rng = np.random.default_rng(SEED + log_scale)
    if twisted:
        u_ = torch.from_numpy(_slots(rng, pd.n) * 2.0 ** -7)
        rows = emb.untwist_round_to_rns_plain(u_, tables.untwist,
                                              2.0 ** log_scale, rt)
        untwist = tables.untwist
    else:
        u_ = torch.from_numpy(rng.uniform(-1, 1, pd.n) * 2.0 ** 10)
        rows = emb.untwist_round_to_rns_plain(u_.to(torch.complex128),
                                              emb._unit_untwist(pd.n, "cpu"),
                                              2.0 ** log_scale, rt)
        untwist = None
    want = ntt.ntt_forward_plain(rows, pd.ntt)
    got = emb.rns_ntt_forward_round(u_, untwist, 2.0 ** log_scale, rt, pd.ntt)
    assert torch.equal(got, want)
    assert torch.equal(got, emb.ntt_forward_round_plain(
        u_, untwist, 2.0 ** log_scale, rt, pd.ntt))


@pytest.mark.parametrize("use_mxu", [False, True], ids=["A", "J"])
def test_route_by_tables(monkeypatch, use_mxu):
    """A's route: one fused call for each encode, no O2; J's route
    (use_mxu=True at n = 2048): O2 (untwist_round_to_rns, round_to_rns),
    then J. Both give the same words."""
    pc, _ = _ctxs(2048, use_mxu)
    calls = {"fused": 0, "round": 0}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(emb, "rns_ntt_forward_round",
                        counted("fused", emb.rns_ntt_forward_round))
    monkeypatch.setattr(emb, "untwist_round_to_rns",
                        counted("round", emb.untwist_round_to_rns))
    monkeypatch.setattr(emb, "round_to_rns",
                        counted("round", emb.round_to_rns))
    rng = np.random.default_rng(SEED + 4)
    vals, coeffs = _slots(rng, 1024), rng.uniform(-1, 1, 2048)
    encoder = P.CKKSEncoder(pc)
    got = (encoder.encode(vals, 2.0 ** 40),
           encoder.encode_polynomial(coeffs, 2.0 ** 40))
    assert calls == ({"fused": 0, "round": 2} if use_mxu
                     else {"fused": 2, "round": 0})
    assert ntt.on_a_route(pc.first_context_data.ntt) is not use_mxu
    other, _ = _ctxs(2048, not use_mxu)
    want = (P.CKKSEncoder(other).encode(vals, 2.0 ** 40),
            P.CKKSEncoder(other).encode_polynomial(coeffs, 2.0 ** 40))
    for g, w in zip(got, want):
        assert torch.equal(g.data, w.data)


def test_fused_wrapper_refuses_what_a_cannot_take():
    pc, _ = _ctxs(1024)
    pd = pc.first_context_data
    tables = emb.make_embed_tables(pd.n, "cpu")
    rt = emb.make_rns_round_tables(pd.ntt)
    c = torch.zeros(pd.n, dtype=torch.float64)
    z = torch.zeros(pd.n, dtype=torch.complex128)
    mxu = ntt.RnsNttTables.from_moduli(
        2048, [int(v) for v in P.CoeffModulus.create(2048, [40])], "cpu",
        use_mxu=True)
    with pytest.raises(ValueError, match="no transform on A"):
        emb.rns_ntt_forward_round(torch.zeros(2048, dtype=torch.float64),
                                  None, 1.0, emb.make_rns_round_tables(mxu),
                                  mxu)
    with pytest.raises(ValueError, match="no transform on A"):
        emb.rns_ntt_forward_round(c, None, 1.0, rt, pd.ntt.pointwise(pd.n))
    with pytest.raises(ValueError, match="expected"):
        emb.rns_ntt_forward_round(c[:-1], None, 1.0, rt, pd.ntt)
    with pytest.raises(ValueError, match="expected"):
        emb.rns_ntt_forward_round(z, tables.untwist[:-1], 1.0, rt, pd.ntt)
    with pytest.raises(TypeError):
        emb.rns_ntt_forward_round(z, None, 1.0, rt, pd.ntt)
    with pytest.raises(TypeError):
        emb.rns_ntt_forward_round(c, tables.untwist, 1.0, rt, pd.ntt)
    with pytest.raises(TypeError):
        emb.rns_ntt_forward_round(c.to(torch.float32), None, 1.0, rt,
                                  pd.ntt)
    other = emb.make_rns_round_tables(pd.ntt.slice(0, pd.ntt.k - 1))
    with pytest.raises(ValueError, match="round tables"):
        emb.rns_ntt_forward_round(c, None, 1.0, other, pd.ntt)
    # a tensor off the CPU never takes the plain version: it launches the
    # kernel or raises
    for u_, untwist in ((c.to("meta"), None), (z.to("meta"), tables.untwist),
                        (z, tables.untwist.to("meta"))):
        with pytest.raises(ValueError, match="expected all on the CPU"):
            emb.rns_ntt_forward_round(u_, untwist, 1.0, rt, pd.ntt)


# --------------------------------------------------------------------------
# the fused first pass's addressing, emulated
# --------------------------------------------------------------------------

def _emulated_round(u_, untwist, scale, rt, log_n, mode, log_line,
                    log_lines, k):
    """The first pass's loads: output word `at` of row r reads word at +
    shift of the source (shift: the block's row's digit_row less its row,
    or the line's digit_row for whole-row blocks) and of the untwist (its
    index within the row), rounds Re(u * untwist) * scale (or u * scale)
    and reduces it into limb r % k with RoundLayout's constants: q, the
    high Barrett word, and 2^e mod q with its Shoup word only where e >
    0."""
    rows = k
    at, row, blk_row = _pass_words(mode, log_line, log_lines, log_n, rows, k)
    assert torch.equal(torch.sort(at).values, torch.arange(rows << log_n)), \
        "the first pass does not load every word once"
    digit_row = lambda r: (r // k) << log_n
    i = at - (row << log_n)
    src = torch.where(blk_row >= 0, at + digit_row(blk_row)
                      - (blk_row << log_n), digit_row(row) + i)
    x = u_[src]
    if untwist is None:
        re = x
    else:
        tw = untwist[src & ((1 << log_n) - 1)]
        re = x.real * tw.real - x.imag * tw.imag
    v = torch.round(re * scale)
    neg, a = v < 0, v.abs()
    E = rt.exponents
    e = (torch.frexp(a)[1].to(torch.int64) - 53).clamp(0, E - 1)
    m = torch.ldexp(a, -e.to(torch.float64)).to(torch.int64)
    c = rt.round_consts
    limb = row % k
    q, ratio = c[limb], c[k + limb]
    r = u.barrett_reduce_64(m, q, ratio)
    at_e = limb * E + e
    scaled = u.mul_mod_shoup(r, c[2 * k + at_e], c[2 * k + k * E + at_e], q)
    r = torch.where(e > 0, scaled, r)
    out = torch.empty(rows << log_n, dtype=torch.int64)
    out[at] = torch.where(neg, u.neg_mod(r, q), r)
    return out.reshape(k, 1 << log_n)


# n = 64: one pass over whole rows (run time); 1024-4096: a compiled
# strided first pass; 262144: a run-time one.
@pytest.mark.parametrize("n", [64, 1024, 4096, 262144])
@pytest.mark.parametrize("twisted", [True, False])
def test_fused_pass_addressing_matches_the_plain_version(n, twisted):
    log_n = n.bit_length() - 1
    plan = _plan(log_n)
    assert [c for *_, c in plan] == {64: [False], 1024: [True, True],
                                     4096: [True, True],
                                     262144: [False, False]}[n]
    bits = [60, 40, 40] if n < 262144 else [40, 40]
    moduli = [int(v) for v in P.CoeffModulus.create(n, bits)]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    rt = emb.make_rns_round_tables(tables)
    k = tables.k
    rng = np.random.default_rng(SEED + n + twisted)
    if twisted:
        u_ = torch.from_numpy(_slots(rng, n) * 2.0 ** -7)
        angle = rng.uniform(0, 2 * np.pi, n)
        untwist = torch.from_numpy(np.cos(angle) + 1j * np.sin(angle))
    else:
        u_ = torch.from_numpy(rng.uniform(-1, 1, n) * 2.0 ** 10)
        untwist = None
    first = plan[0][:3]
    for scale in (2.0 ** 40, 2.0 ** 100):
        rows = _emulated_round(u_, untwist, scale, rt, log_n, *first, k)
        assert torch.equal(rows, emb.untwist_round_to_rns_plain(
            u_, untwist, scale, rt))
        if n <= 4096:
            # the whole fused forward: the emulated rounding, then A's
            assert torch.equal(ntt.ntt_forward_plain(rows, tables),
                               emb.rns_ntt_forward_round(u_, untwist, scale,
                                                         rt, tables))
