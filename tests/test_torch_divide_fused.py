"""The divide by the last prime in the NTT domain with kernel K' (and
K'-BGV) folded into kernel A's forward passes (troy_tpu_torch/ops/rns.py
``ntt_forward_divide``, csrc/ntt.cu) against troy_tpu, word for word
(tolerance 0), on the CPU.

CKKS and BGV contexts at n = 64 (A's one pass over whole rows), 1024 and
4096 (two passes) over q = {60,40,40,60} (60- and 40-bit data primes under
a 60-bit special prime) and q = {40,40,40,40}; BGV with t =
PlainModulus.batching(n, 20); random words below each limb's modulus and
random key words from numpy seeds:
  * the CKKS rescale ``divide_and_round_q_last_ntt`` and the BGV mod
    switch ``mod_t_and_divide_q_last_ntt`` against troy_tpu/ops/rns.py:213
    and :246, at every level;
  * the port's CKKS and BGV ``relinearize`` and ``apply_galois`` and the
    NTT-form BGV ``mod_switch_to_next`` against troy_tpu's;
  * the fused wrapper against the unfused composition (K''s temps, A's
    lazy forward, K''s finish) for every accumulator layout: none,
    (c0, c1), c0, the batched fold's groups (one c0 a ciphertext, and one
    for all), and a limb shard (``_divide_by_special(limbs=)``);
  * the wrapper's refusals (J's tables, a pointwise view, a wrong shape,
    more than 64 limbs);
  * a plain-torch emulation of the fused passes' addressing (csrc/ntt.cu's
    plan, block, line and word maps, its geometry read from the source):
    which word of ``last`` each first-pass word loads, and which x and
    accumulator words each last-pass word reads, at the compiled
    geometries and the run-time ones, held to the plain version. The
    kernel cannot run here; this is what guards its addressing on the CPU.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu.ops import rns as jrns

import troy_tpu_torch as P
from troy_tpu_torch import evaluator as pev
from troy_tpu_torch import interop
from troy_tpu_torch.ops import keyswitch, ntt, rns
from troy_tpu_torch.ops import u64ops as u
from troy_tpu_torch.utils import numth

torch.set_num_threads(2)

SEED = 5151
BITS = {"60/40": [60, 40, 40, 60], "40": [40, 40, 40, 40]}
NS = (64, 1024, 4096)

_CTX = {}


def _ctxs(scheme, n, bits):
    """(port context, troy_tpu context) of ``scheme`` at n over
    BITS[bits]."""
    key = (scheme, n, bits)
    if key not in _CTX:
        out = []
        for mod in (P, J):
            kw = {}
            if scheme == "bgv":
                kw["plain_modulus"] = mod.PlainModulus.batching(n, 20)
            parms = mod.EncryptionParameters(
                scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
                coeff_modulus=tuple(mod.CoeffModulus.create(n, BITS[bits])),
                **kw)
            # troy_tpu on its butterfly NTT (its MXU path gives the same
            # words and compiles for 4 times as long at n = 4096)
            on = {"device": "cpu"} if mod is P else {"use_mxu": False}
            out.append(mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                     **on))
        _CTX[key] = tuple(out)
    return _CTX[key]


def _words(rng, moduli, lead, n):
    return np.concatenate([rng.integers(0, q, size=lead + (1, n),
                                        dtype=np.uint64) for q in moduli],
                          axis=-2)


def _t(words):
    return interop.to_torch(words, "cpu")


def _equal(port: torch.Tensor, ref) -> None:
    got, want = interop.to_numpy(port), np.asarray(ref)
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0, "words differ"


# --------------------------------------------------------------------------
# the ops against troy_tpu
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", list(BITS))
@pytest.mark.parametrize("n", NS)
def test_rescale_and_bgv_mod_switch_match_troy_tpu(n, bits):
    for scheme in ("ckks", "bgv"):
        pctx, jctx = _ctxs(scheme, n, bits)
        for level in range(pctx.first_level, pctx.last_level):
            pcd, jcd = pctx.get_context_data(level), jctx.get_context_data(
                level)
            rng = np.random.default_rng(SEED + n + level)
            x = _words(rng, pcd.coeff_values, (2,), n)
            if scheme == "ckks":
                want = [jrns.divide_and_round_q_last_ntt(
                    jnp.asarray(x[c]), jcd.rns_tool, jcd.ntt)
                    for c in range(2)]
                got = rns.divide_and_round_q_last_ntt(_t(x), pcd.ntt,
                                                      pcd.rescale_consts)
            else:
                want = [jrns.mod_t_and_divide_q_last_ntt(
                    jnp.asarray(x[c]), jcd.rns_tool, jcd.ntt)
                    for c in range(2)]
                got = rns.mod_t_and_divide_q_last_ntt(
                    _t(x), pcd.ntt, pcd.bgv_mod_switch_consts)
            _equal(got, np.stack([np.asarray(w) for w in want]))


def _key_words(rng, key_cd, n):
    return _words(rng, key_cd.coeff_values, (key_cd.limbs - 1, 2), n)


@pytest.mark.parametrize("bits", list(BITS))
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("scheme", ["ckks", "bgv"])
def test_key_switching_ops_match_troy_tpu(scheme, n, bits):
    """relinearize and apply_galois of random NTT-form ciphertexts under
    random key words, and BGV's NTT-form mod_switch_to_next."""
    pctx, jctx = _ctxs(scheme, n, bits)
    rng = np.random.default_rng(SEED + n + len(bits))
    cd = pctx.first_context_data
    rlk = _key_words(rng, pctx.key_context_data, n)
    gk = _key_words(rng, pctx.key_context_data, n)
    elt = 3
    meta = {"scale": 2.0 ** 20} if scheme == "ckks" else {
        "correction_factor": 5}
    ct3 = _words(rng, cd.coeff_values, (3,), n)
    ct2 = _words(rng, cd.coeff_values, (2,), n)
    pev_, jev_ = P.Evaluator(pctx), J.Evaluator(jctx)
    prlk = interop.relin_keys({2: rlk}, "cpu")
    jrlk = J.RelinKeys(keys={2: jnp.asarray(rlk)})
    pgk = interop.galois_keys({elt: gk}, "cpu")
    jgk = J.GaloisKeys(keys={elt: jnp.asarray(gk)})

    def pair(words):
        return (interop.ciphertext(words, pctx.first_level, True, "cpu",
                                   **meta),
                J.Ciphertext(data=jnp.asarray(words), level=jctx.first_level,
                             is_ntt_form=True, **meta))

    ops = [("relinearize", lambda e, c, keys: e.relinearize(c, keys),
            ct3, (prlk, jrlk)),
           ("apply_galois", lambda e, c, keys: e.apply_galois(c, elt, keys),
            ct2, (pgk, jgk))]
    if scheme == "bgv":
        ops.append(("mod_switch_to_next",
                    lambda e, c, keys: e.mod_switch_to_next(c), ct2,
                    (None, None)))
    for name, op, words, (pkeys, jkeys) in ops:
        pct, jct = pair(words)
        got, want = op(pev_, pct, pkeys), op(jev_, jct, jkeys)
        assert got.level == want.level, name
        assert got.correction_factor == want.correction_factor, name
        assert got.scale == want.scale, name
        _equal(got.data, want.data)


# --------------------------------------------------------------------------
# the fused wrapper against the unfused composition
# --------------------------------------------------------------------------

ENTRIES = {"rescale": rns.RESCALE, "keyswitch": rns.KEYSWITCH,
           "bgv_mod_switch": rns.BGV_MOD_SWITCH,
           "bgv_keyswitch": rns.BGV_KEYSWITCH}


def _divide_case(n, k, s, bgv, seed):
    """A's tables of k data primes and the prime p above them, x (s, k+1,
    n), last (s, n) below p, and the divide's constants."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, [40] * k + [60])]
    key = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    t, p = key.slice(0, k), moduli[k]
    rng = np.random.default_rng(seed)
    x = _t(_words(rng, moduli, (s,), n))
    last = _t(_words(rng, [p], (s,), n))[:, 0]
    consts = (keyswitch.bgv_divide_consts(
        t, p, int(P.PlainModulus.batching(n, 20))) if bgv
        else keyswitch.divide_round_consts(t, p))
    return key, t, x, last, consts, rng


# (acc lead shape, group): none, (c0, c1), c0, the batched fold's c0 of
# each ciphertext, one c0 for every ciphertext
LAYOUTS = {"none": (None, None), "c0c1": ((2,), None), "c0": ((1,), None),
           "fold": ((3, 1), 2), "fold_shared": ((1, 1), 2)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("use", list(ENTRIES))
@pytest.mark.parametrize("n", [64, 1024])
def test_fused_forward_is_the_unfused_composition(n, use, layout):
    entries = ENTRIES[use]
    bgv = use.startswith("bgv")
    k, s = 3, 6
    key, t, x, last, consts, rng = _divide_case(n, k, s, bgv,
                                                SEED + n + len(use))
    lead, group = LAYOUTS[layout]
    acc = None if lead is None else _t(_words(rng, t.values, lead, n))
    got = rns.ntt_forward_divide(entries[2], x, last, t, consts, acc, group)
    temps = ntt.rns_ntt_forward(rns._ntt_temps(entries[0], last, consts), t,
                                lazy=True)
    want = rns._ntt_finish(entries[1], x, temps, consts[:5 * k + 2], acc,
                           group)
    assert torch.equal(got, want)
    assert torch.equal(got, rns.ntt_forward_divide_plain(
        x, last, t, consts, acc, group, bgv))
    # the whole divide: A's inverse of row k, then the fused forward
    x_ntt = x.clone()
    x_ntt[:, k] = ntt.rns_ntt_forward(last.unsqueeze(1), key.slice(k, k + 1))[
        :, 0]
    inv = ntt.rns_ntt_inverse(x_ntt[:, k:], key.slice(k, k + 1))[:, 0]
    assert torch.equal(inv, last)
    assert torch.equal(rns.divide_round_last_ntt(
        x_ntt, t, key.slice(k, k + 1), consts, acc, entries, group), got)


@pytest.mark.parametrize("scheme", ["ckks", "bgv"])
@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_limb_shard_divides_its_rows(shard, scheme):
    """A shard of the limb axis (``_divide_by_special(limbs=)``) gives the
    rows of the whole divide, with the accumulator's rows of the shard."""
    n = 1024
    pctx, _ = _ctxs(scheme, n, "40")
    cd, key_cd = pctx.first_context_data, pctx.key_context_data
    used = pev._used_tables(cd, key_cd)
    rng = np.random.default_rng(SEED + shard[0] + len(scheme))
    prods = _t(_words(rng, used.values, (2,), n))
    acc = _t(_words(rng, cd.coeff_values, (2,), n))
    whole = pev._divide_by_special(prods, cd, key_cd, True, acc)
    limbs = range(*shard)
    rows = list(limbs) + [cd.limbs]
    got = pev._divide_by_special(prods[:, rows], cd, key_cd, True,
                                 acc[:, limbs.start:limbs.stop],
                                 limbs=limbs)
    assert torch.equal(got, whole[:, limbs.start:limbs.stop])


def test_fused_forward_refuses_what_a_cannot_take():
    n = 2048
    moduli = [int(m) for m in P.CoeffModulus.create(n, [40, 40, 40])]
    on_a = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    on_j = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=True)
    t = on_a.slice(0, 2)
    consts = keyswitch.divide_round_consts(t, moduli[2])
    x = torch.zeros((2, 3, n), dtype=torch.int64)
    last = torch.zeros((2, n), dtype=torch.int64)
    entry = rns.KEYSWITCH[2]
    with pytest.raises(ValueError, match="no transform on A"):
        rns.ntt_forward_divide(entry, x, last, on_j.slice(0, 2), consts)
    with pytest.raises(ValueError, match="no transform on A"):
        rns.ntt_forward_divide(entry, x, last, t.pointwise(n), consts)
    for bad_x, bad_last in ((x[:, :2], last), (x, last[:1]),
                            (x[..., :64], last)):
        with pytest.raises(ValueError, match="do not fit"):
            rns.ntt_forward_divide(entry, bad_x, bad_last, t, consts)
    with pytest.raises(ValueError, match="do not fit"):
        rns.ntt_forward_divide(rns.BGV_KEYSWITCH[2], x, last, t, consts)
    with pytest.raises(ValueError, match="does not fit"):
        rns.ntt_forward_divide(entry, x, last, t, consts,
                               torch.zeros((3, 2, n), dtype=torch.int64))
    # more limbs than the kernel takes (on either device: the plain
    # version keeps the kernel's domain)
    k = keyswitch.MAX_KERNEL_LIMBS + 1
    wide = numth.get_primes(128, 30, k + 1)       # past CoeffModulus's 64
    wt = ntt.RnsNttTables.from_moduli(64, wide[:k], "cpu", use_mxu=False)
    with pytest.raises(ValueError, match="at most 64"):
        rns.ntt_forward_divide(
            entry, torch.zeros((1, k + 1, 64), dtype=torch.int64),
            torch.zeros((1, 64), dtype=torch.int64), wt,
            keyswitch.divide_round_consts(wt, wide[k]))


# --------------------------------------------------------------------------
# the fused passes' addressing, emulated
# --------------------------------------------------------------------------

def _geometry():
    """(kLogTile, kSplitLogN) as csrc/ntt.cu sets them."""
    src = (Path(ntt.__file__).resolve().parents[1] / "csrc"
           / "ntt.cu").read_text()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                     src).group(1))
    return get("kLogTile"), get("kSplitLogN")


ROWS, COLS, CHUNKS = 0, 1, 2


def _plan(log_n):
    """csrc/ntt.cu plan() of a forward transform: (mode, log_line,
    log_lines) of each pass, and whether it runs a compiled geometry
    (2^kLogTile-word tiles of 2^5-2^8-word lines) or the run-time one."""
    log_tile, split = _geometry()
    if log_n < split:
        return [(ROWS, log_n, log_tile - log_n, False)]
    a = log_n // 2
    b = log_n - a
    clamp = lambda v, hi: max(0, min(v, hi))
    passes = [(COLS, a, clamp(log_tile - a, b)),
              (CHUNKS, b, clamp(log_tile - b, a))]
    return [(m, ll, ls, ll + ls == log_tile and 5 <= ll <= 8)
            for m, ll, ls in passes]


def _pass_words(mode, log_line, log_lines, log_n, rows, k):
    """Every word a pass touches, as the kernel enumerates them: (its
    index into the (rows, n) output, its line's row (the source and finish
    maps' input), its block's row (-1 for whole-row blocks)), one entry a
    (block, f) pair whose line is a row; f < 2^(log_line + log_lines), l
    and i from f as the kernel's load and store loops take them."""
    words = 1 << (log_line + log_lines)
    f = torch.arange(words)
    if mode == COLS:
        l, i = f & ((1 << log_lines) - 1), f >> log_lines
    else:
        l, i = f >> log_line, f & ((1 << log_line) - 1)
    n = 1 << log_n
    if mode == ROWS:
        blocks = (rows + (1 << log_lines) - 1) >> log_lines
        blk = torch.arange(blocks).unsqueeze(1)
        row = (blk << log_lines) + l
        base = row << log_n
        at = base + i
        keep = row < rows
        return at[keep], row[keep], torch.full_like(at[keep], -1)
    log_per_row = log_n - log_line - log_lines
    blocks = rows << log_per_row
    blk = torch.arange(blocks).unsqueeze(1)
    row = blk >> log_per_row
    first = (blk & ((1 << log_per_row) - 1)) << log_lines
    if mode == COLS:
        at = (row << log_n) + first + l + i * (1 << (log_n - log_line))
    else:
        at = (row << log_n) + ((first + l) << log_line) + i
    row = row.expand_as(at)
    return at.flatten(), row.flatten(), row.flatten()


def _emulated_load(last, t, consts, bgv, log_n, mode, log_line, log_lines,
                   k):
    """The first pass's loads: output word `at` of row r reads word at +
    shift of `last` (shift: the block's row's digit_row less its row, or
    the line's digit_row for whole-row blocks) and forms limb r % k's
    temp."""
    rows = last.shape[0] * k
    at, row, blk_row = _pass_words(mode, log_line, log_lines, log_n, rows, k)
    assert torch.equal(torch.sort(at).values, torch.arange(rows << log_n)), \
        "the first pass does not load every word once"
    digit_row = lambda r: (r // k) << log_n
    i = at - (row << log_n)
    src = torch.where(blk_row >= 0, at + digit_row(blk_row)
                      - (blk_row << log_n), digit_row(row) + i)
    limb = row % k
    lw = last.flatten()[src]
    q = consts[limb]
    ratio = consts[k + limb]
    if bgv:
        tt, tt_hi, inv, inv_shoup = (int(v) & u.M64 for v in
                                     consts[5 * k + 2:5 * k + 6].tolist())
        neg_k = u.mul_mod_shoup(u.neg_mod(u.barrett_reduce_64(
            lw, tt, tt_hi), tt), inv, inv_shoup, tt)
        delta = u.mul_mod_shoup(u.barrett_reduce_64(neg_k, q, ratio),
                                consts[5 * k + 6 + limb],
                                consts[6 * k + 6 + limb], q)
        temp = u.add_mod(delta, u.barrett_reduce_64(lw, q, ratio), q)
    else:
        p, half = (int(v) & u.M64 for v in consts[5 * k:5 * k + 2].tolist())
        temp = u.barrett_reduce_64(u.add_mod(lw, half, p), q, ratio) \
            + q - consts[2 * k + limb]
    out = torch.empty(rows << log_n, dtype=torch.int64)
    out[at] = temp
    return out.reshape(last.shape[0], k, 1 << log_n)


def _emulated_finish(v, x, acc, group, consts, log_n, mode, log_line,
                     log_lines, k):
    """The last pass's stores: output word `at` of row r = comp k + j
    reads x at at + comp n and, where accumulator_row(comp) >= 0, acc at
    at + (arow - comp) k n."""
    s = v.shape[0]
    rows = s * k
    at, row, _ = _pass_words(mode, log_line, log_lines, log_n, rows, k)
    assert torch.equal(torch.sort(at).values, torch.arange(rows << log_n)), \
        "the last pass does not store every word once"
    n = 1 << log_n
    comp, j = row // k, row % k
    acc4, a, group, groups = keyswitch.accumulator_layout(acc, s, k, n,
                                                          group, "emulated")
    g, h = comp // group, comp % group
    arow = torch.where(h < a, (g % groups) * a + h, torch.full_like(h, -1))
    q, inv, inv_shoup = (consts[o * k + j] for o in (0, 3, 4))
    word = u.mul_mod_shoup(x.flatten()[at + comp * n] + 4 * q
                           - v.flatten()[at], inv, inv_shoup, q)
    if acc4 is not None:
        has = arow >= 0
        off = (arow - comp) * k * n
        aw = acc4.flatten()[(at + off)[has]]
        word[has] = u.add_mod(aw, word[has], q[has])
    out = torch.empty(rows << log_n, dtype=torch.int64)
    out[at] = word
    return out.reshape(s, k, n)


# n = 64: one pass over whole rows (load and finish in one run-time pass);
# 1024-4096: both passes compiled; 131072: a compiled first pass and a
# run-time last; 262144: both passes run-time
@pytest.mark.parametrize("n,k,s", [(64, 3, 6), (1024, 3, 6), (4096, 2, 6),
                                   (131072, 1, 2), (262144, 1, 2)])
@pytest.mark.parametrize("bgv", [False, True], ids=["ckks", "bgv"])
def test_fused_passes_addressing_matches_the_plain_version(n, k, s, bgv):
    log_n = n.bit_length() - 1
    plan = _plan(log_n)
    compiled = [c for *_, c in plan]
    expect = {64: [False], 1024: [True, True], 4096: [True, True],
              131072: [True, False], 262144: [False, False]}[n]
    assert compiled == expect
    moduli = [int(m) for m in P.CoeffModulus.create(
        n, [40] * k + [55] if n > 4096 else [40] * k + [60])]
    t = ntt.RnsNttTables.from_moduli(n, moduli[:k], "cpu", use_mxu=False)
    p = moduli[k]
    rng = np.random.default_rng(SEED + n + k + bgv)
    x = _t(_words(rng, moduli, (s,), n))
    last = _t(_words(rng, [p], (s,), n))[:, 0]
    tt = int(P.PlainModulus.batching(n, 20 if n <= 4096 else 30))
    consts = (keyswitch.bgv_divide_consts(t, p, tt) if bgv
              else keyswitch.divide_round_consts(t, p))
    want_temps = (rns.bgv_divide_ntt_temps_plain if bgv
                  else rns.divide_round_ntt_temps_plain)(last, consts)
    first, final = plan[0], plan[-1]
    temps = _emulated_load(last, t, consts, bgv, log_n, *first[:3], k)
    assert torch.equal(temps, want_temps)
    # the butterflies between are A's own (their words are held to the
    # plain version elsewhere); arbitrary lazy words stand in for them
    v = _t(_words(rng, [4 * q for q in t.values], (s,), n))
    for lead, group in LAYOUTS.values():
        if lead is not None and lead[0] > s:
            continue
        acc = None if lead is None else _t(_words(rng, t.values, lead, n))
        got = _emulated_finish(v, x, acc, group, consts, log_n, *final[:3],
                               k)
        assert torch.equal(got, rns.divide_round_ntt_finish_plain(
            x, v, consts[:5 * k + 2], acc, group))
    if n <= 4096:
        # the whole fused forward: the emulated load, A's lazy forward, the
        # emulated finish
        acc = _t(_words(rng, t.values, (2,), n))
        lazy = ntt.ntt_forward_plain(temps, t, lazy=True)
        got = _emulated_finish(lazy, x, acc, None, consts, log_n,
                               *final[:3], k)
        assert torch.equal(got, rns.ntt_forward_divide_plain(
            x, last, t, consts, acc, None, bgv))
