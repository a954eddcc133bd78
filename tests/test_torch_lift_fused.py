"""The plain lift folded into kernel A's first forward pass (AGp,
troy_tpu_torch/ops/ntt.py ``rns_ntt_forward_lift``, csrc/ntt.cu
``troy_ntt_forward_lift``) against troy_tpu, word for word (tolerance 0),
on the CPU.

BFV and BGV contexts at n = 1024 over q = {60,40,40,60} with t =
PlainModulus.batching(n, 20) (t below every data prime) and over
q = {60,40,40,40,40,60} with a 59-bit t (above the 40-bit primes: the
Barrett branch of the lift, below the 60-bit one); random words mod t from
numpy seeds:
  * the port's ``_plain_to_ntt`` (one AGp call on A's route) against
    troy_tpu/evaluator.py:708 ``_plain_to_ntt`` (threshold (t+1)/2), at
    the first data level and the last, with leading batch axes, and times a
    correction factor (the BGV add_plain's m * cf mod t,
    troy_tpu/evaluator.py:767-768);
  * the port's ``_plain_operand`` (threshold t) against the BGV encrypt's
    lift and transform (troy_tpu/encryptor.py:44-48);
  * the route: AGp on A's route, kernel G' and J's transform on J's
    (``use_mxu=True``), both giving troy_tpu's words;
  * the wrapper against G''s plain version then A's forward, and its
    refusals (J's tables, a pointwise view, a wrong length);
  * a plain-torch emulation of the fused first pass's addressing
    (csrc/ntt.cu's plan, block, line and word maps, read from the source
    by tests/test_torch_divide_fused.py's helpers): which source word each
    output word lifts, into which limb, held to the plain version at the
    compiled geometries and the run-time ones. The kernel cannot run here;
    this is what guards its addressing on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu import encryptor as jenc
from troy_tpu import evaluator as jev
from test_torch_divide_fused import _pass_words, _plan

import troy_tpu_torch as P
from troy_tpu_torch import encryptor as penc
from troy_tpu_torch import evaluator as pev
from troy_tpu_torch import interop
from troy_tpu_torch.ops import ntt, poly
from troy_tpu_torch.ops import u64ops as u

torch.set_num_threads(2)

SEED = 9191
CONFIGS = {"t20": (1024, [60, 40, 40, 60], 20),
           "t59": (1024, [60, 40, 40, 40, 40, 60], 59)}
# the route's: n = 2048, where use_mxu=True puts the transforms on J
ROUTE_CONFIG = (2048, [60, 40, 40, 60], 20)

_CTX = {}


def _ctxs(scheme, config, use_mxu=False):
    """(port context, troy_tpu context) of ``scheme`` at CONFIGS[config];
    the port on J's tables with ``use_mxu``."""
    key = (scheme, config, use_mxu)
    if key not in _CTX:
        n, bits, t_bits = CONFIGS.get(config, ROUTE_CONFIG)
        out = []
        for mod in (P, J):
            parms = mod.EncryptionParameters(
                scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
                coeff_modulus=tuple(mod.CoeffModulus.create(n, bits)),
                plain_modulus=mod.PlainModulus.batching(n, t_bits))
            on = ({"device": "cpu", "use_mxu": use_mxu} if mod is P
                  else {"use_mxu": False})
            out.append(mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                     **on))
        _CTX[key] = tuple(out)
    return _CTX[key]


def _plain(rng, t, lead, n):
    return rng.integers(0, t, size=lead + (n,), dtype=np.uint64)


def _equal(port: torch.Tensor, ref) -> None:
    got, want = interop.to_numpy(port), np.asarray(ref)
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0, "words differ"


def _levels(pc, jc):
    """The (port, troy_tpu) context data of the first data level and the
    last."""
    return [(pc.first_context_data, jc.first_context_data),
            (pc.last_context_data, jc.last_context_data)]


# --------------------------------------------------------------------------
# the callers against troy_tpu
# --------------------------------------------------------------------------

@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_plain_to_ntt_matches_troy_tpu(scheme, config):
    pc, jc = _ctxs(scheme, config)
    rng = np.random.default_rng(SEED + len(config) + len(scheme))
    for pd, jd in _levels(pc, jc):
        t = int(pd.plain_modulus)
        m = _plain(rng, t, (), pd.n)
        m[:4] = [0, t - 1, (t + 1) >> 1, ((t + 1) >> 1) - 1]  # the edges
        want = jev._plain_to_ntt(jnp.asarray(m), jd)
        _equal(pev._plain_to_ntt(interop.to_torch(m, "cpu"), pd), want)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_plain_to_ntt_times_a_correction_factor(config):
    """The BGV add_plain's lift of m * cf mod t: the port passes cf to the
    fused call, troy_tpu scales first (evaluator.py:767-768)."""
    pc, jc = _ctxs("bgv", config)
    pd, jd = pc.first_context_data, jc.first_context_data
    t = int(pd.plain_modulus)
    rng = np.random.default_rng(SEED + 1)
    m = _plain(rng, t, (), pd.n)
    for cf in (2, 4321, t - 1, t + 5):
        scaled = (m.astype(object) * (cf % t) % t).astype(np.uint64)
        want = jev._plain_to_ntt(jnp.asarray(scaled), jd)
        _equal(pev._plain_to_ntt(interop.to_torch(m, "cpu"), pd, cf), want)


def test_plain_to_ntt_with_leading_axes():
    """The app's weight tiles: (I, Y, n) in one call, each row the words of
    troy_tpu's lift of that row."""
    pc, jc = _ctxs("bfv", "t59")
    pd, jd = pc.first_context_data, jc.first_context_data
    rng = np.random.default_rng(SEED + 2)
    m = _plain(rng, int(pd.plain_modulus), (3, 2), pd.n)
    got = interop.to_numpy(pev._plain_to_ntt(interop.to_torch(m, "cpu"), pd))
    assert got.shape == (3, 2, pd.ntt.k, pd.n)
    for i in range(3):
        for j in range(2):
            _equal(interop.to_torch(got[i, j], "cpu"),
                   jev._plain_to_ntt(jnp.asarray(m[i, j]), jd))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_bgv_encrypt_operand_matches_troy_tpu(config):
    """Threshold t (the raw residues of the BGV encrypt): the port's
    ``_plain_operand`` against troy_tpu's embed into a zero c0."""
    pc, jc = _ctxs("bgv", config)
    pd, jd = pc.first_context_data, jc.first_context_data
    t = int(pd.plain_modulus)
    rng = np.random.default_rng(SEED + 3)
    m = _plain(rng, t, (), pd.n)
    m[:2] = [t - 1, (t + 1) >> 1]
    zero = jnp.zeros((pd.ntt.k, pd.n), dtype=jnp.uint64)
    want = jenc._embed_plain_c0(jnp.asarray(m), zero, jd)
    _equal(penc._plain_operand(interop.to_torch(m, "cpu"), pd), want)


@pytest.mark.parametrize("use_mxu", [False, True], ids=["A", "J"])
def test_route_by_tables(monkeypatch, use_mxu):
    """A's route: one fused call, no G'; J's route (use_mxu=True at
    n = 2048): G', then J. Both give troy_tpu's words."""
    pc, jc = _ctxs("bgv", "route", use_mxu)
    pd, jd = pc.first_context_data, jc.first_context_data
    calls = {"fused": 0, "lift": 0}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(poly, "rns_ntt_forward_lift",
                        counted("fused", poly.rns_ntt_forward_lift))
    monkeypatch.setattr(poly, "plain_lift", counted("lift", poly.plain_lift))
    t = int(pd.plain_modulus)
    m = _plain(np.random.default_rng(SEED + 4), t, (), pd.n)
    got = pev._plain_to_ntt(interop.to_torch(m, "cpu"), pd)
    _equal(got, jev._plain_to_ntt(jnp.asarray(m), jd))
    assert calls == ({"fused": 0, "lift": 1} if use_mxu
                     else {"fused": 1, "lift": 0})
    assert ntt.on_a_route(pd.ntt) is not use_mxu


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------

def test_fused_wrapper_is_the_lift_then_the_transform():
    pc, _ = _ctxs("bgv", "t59")
    pd = pc.first_context_data
    t, Q = int(pd.plain_modulus), pd.total_coeff_modulus
    rng = np.random.default_rng(SEED + 5)
    m = interop.to_torch(_plain(rng, t, (2,), pd.n), "cpu")
    for threshold in (pd.plain_upper_half_threshold, t):
        for cf in (1, 77):
            want = ntt.ntt_forward_plain(
                poly.plain_lift_plain(m, pd.ntt, t, threshold, Q, cf),
                pd.ntt)
            got = ntt.rns_ntt_forward_lift(m, pd.ntt, t, threshold, Q, cf)
            assert torch.equal(got, want)
            assert torch.equal(got, ntt.ntt_forward_lift_plain(
                m, pd.ntt, t, threshold, Q, cf))


def test_fused_wrapper_refuses_what_a_cannot_take():
    pc, _ = _ctxs("bgv", "t20")
    pd = pc.first_context_data
    t, Q = int(pd.plain_modulus), pd.total_coeff_modulus
    m = torch.zeros(pd.n, dtype=torch.int64)
    mxu = ntt.RnsNttTables.from_moduli(2048, [int(v) for v in
                                              P.CoeffModulus.create(2048,
                                                                    [40])],
                                       "cpu", use_mxu=True)
    with pytest.raises(ValueError, match="no transform on A"):
        ntt.rns_ntt_forward_lift(torch.zeros(2048, dtype=torch.int64), mxu,
                                 t, t, Q)
    with pytest.raises(ValueError, match="no transform on A"):
        ntt.rns_ntt_forward_lift(m, pd.ntt.pointwise(pd.n), t, t, Q)
    with pytest.raises(ValueError, match="expected"):
        ntt.rns_ntt_forward_lift(m[:-1], pd.ntt, t, t, Q)
    with pytest.raises(TypeError):
        ntt.rns_ntt_forward_lift(m.to(torch.int32), pd.ntt, t, t, Q)


# --------------------------------------------------------------------------
# the fused first pass's addressing, emulated
# --------------------------------------------------------------------------

def _emulated_lift(m, tables, plain_modulus, threshold, total_q, cf, log_n,
                   mode, log_line, log_lines, k):
    """The first pass's loads: output word `at` of row r reads word at +
    shift of the source (shift: the block's row's digit_row less its row,
    or the line's digit_row for whole-row blocks), scales it by cf mod t
    and lifts it into limb r % k with G''s arithmetic (LiftLayout
    constants)."""
    rows = m.shape[0] * k
    at, row, blk_row = _pass_words(mode, log_line, log_lines, log_n, rows, k)
    assert torch.equal(torch.sort(at).values, torch.arange(rows << log_n)), \
        "the first pass does not load every word once"
    digit_row = lambda r: (r // k) << log_n
    i = at - (row << log_n)
    src = torch.where(blk_row >= 0, at + digit_row(blk_row)
                      - (blk_row << log_n), digit_row(row) + i)
    consts = poly.plain_lift_consts(tables, plain_modulus, total_q)
    limb = row % k
    q, cr_hi, inc = (consts[o + limb] for o in (1, 1 + k, 1 + 2 * k))
    mv = m.flatten()[src]
    cf %= plain_modulus
    if cf != 1:
        mv = u.mul_mod_shoup(mv, cf, u.shoup_quotient(cf, plain_modulus),
                             plain_modulus)
    mj = torch.where(q >= plain_modulus, mv, u.barrett_reduce_64(mv, q,
                                                                 cr_hi))
    word = torch.where(mv >= threshold, u.add_mod(mj, inc, q), mj)
    out = torch.empty(rows << log_n, dtype=torch.int64)
    out[at] = word
    return out.reshape(m.shape[0], k, 1 << log_n)


# n = 64: one pass over whole rows (run time); 1024-4096: a compiled
# strided first pass; 262144: a run-time one. 40-bit primes take the
# lift's Barrett branch (t = 2^41 + 1 above them), 60-bit ones not.
@pytest.mark.parametrize("n,s,bits", [(64, 5, [40, 40, 60]),
                                      (1024, 3, [60, 40]),
                                      (4096, 2, [40, 40, 60]),
                                      (262144, 1, [40])])
def test_fused_pass_addressing_matches_the_plain_version(n, s, bits):
    log_n = n.bit_length() - 1
    plan = _plan(log_n)
    assert [c for *_, c in plan] == {64: [False], 1024: [True, True],
                                     4096: [True, True],
                                     262144: [False, False]}[n]
    moduli = [int(v) for v in P.CoeffModulus.create(n, bits)]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    k = tables.k
    Q = 1
    for v in moduli:
        Q *= v
    tt = 1 << 41 | 1                     # between the 40- and 60-bit primes
    rng = np.random.default_rng(SEED + n + k)
    m = interop.to_torch(_plain(rng, tt, (s,), n), "cpu")
    first = plan[0][:3]
    for threshold, cf in (((tt + 1) >> 1, 1), (tt, 1), ((tt + 1) >> 1, 99)):
        lifted = _emulated_lift(m, tables, tt, threshold, Q, cf, log_n,
                                *first, k)
        assert torch.equal(lifted, poly.plain_lift_plain(
            m, tables, tt, threshold, Q, cf))
        if n <= 4096:
            # the whole fused forward: the emulated lift, then A's forward
            assert torch.equal(ntt.ntt_forward_plain(lifted, tables),
                               ntt.rns_ntt_forward_lift(m, tables, tt,
                                                        threshold, Q, cf))
