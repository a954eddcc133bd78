"""The key switch's divide by the special prime in the coefficient domain
with kernel F's divide folded into kernel A's last inverse pass (AFi,
troy_tpu_torch/ops/keyswitch.py ``ntt_inverse_divide_round``,
csrc/ntt.cu ``troy_ntt_inverse_keyswitch``) on the CPU, word for word
(tolerance 0):

  * the fused wrapper against A's inverse followed by F's divide
    (``rns_ntt_inverse`` then ``divide_round_last``) and against its plain
    version, in every accumulator layout (none, (c0, c1), c0, the batched
    fold's groups with one c0 a ciphertext and one for all), at n = 64
    (the one pass over whole rows), 1024 and 4096 (two passes), and for a
    limb shard (``_divide_by_special(limbs=)``);
  * the port's BFV coefficient-form ``relinearize`` and ``rotate_rows``
    against troy_tpu's at n = 1024 and 4096, and the evaluator's route
    (the fused call on A's route, A's inverse and F's divide on J's);
  * the wrapper's refusals (J's tables, a pointwise view, a wrong shape,
    more than 64 limbs);
  * a plain-torch emulation of the fused pass's addressing (its plan,
    block, tile and word maps, the geometry read from csrc/ntt.cu): which
    source words each tile loads, which accumulator word each finished
    word reads and where it is stored, at the compiled geometries and the
    run-time ones, held to the plain version. The kernel cannot run here;
    this is what guards its addressing on the CPU.

Random words below each limb's modulus and random key words from numpy
seeds.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J

import troy_tpu_torch as P
from troy_tpu_torch import evaluator as pev
from troy_tpu_torch import interop
from troy_tpu_torch.ops import keyswitch, ntt
from troy_tpu_torch.ops import u64ops as u
from troy_tpu_torch.utils import numth

torch.set_num_threads(2)

SEED = 7171
BITS = [60, 40, 40, 60]

_CTX = {}


def _ctxs(n, use_mxu=None):
    """(port context, troy_tpu context) of BFV at n over BITS, t =
    PlainModulus.batching(n, 20)."""
    key = (n, use_mxu)
    if key not in _CTX:
        out = []
        for mod in (P, J):
            parms = mod.EncryptionParameters(
                scheme=mod.SchemeType.bfv, poly_modulus_degree=n,
                coeff_modulus=tuple(mod.CoeffModulus.create(n, BITS)),
                plain_modulus=mod.PlainModulus.batching(n, 20))
            on = ({"device": "cpu", "use_mxu": use_mxu} if mod is P
                  else {"use_mxu": False})
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


def _case(n, k, s, seed):
    """The tables of k data primes and the special prime above them, the
    products x (s, k+1, n) and the divide's constants."""
    moduli = [int(m) for m in P.CoeffModulus.create(n, [40] * k + [60])]
    rows = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    rng = np.random.default_rng(seed)
    x = _t(_words(rng, moduli, (s,), n))
    consts = keyswitch.divide_round_consts(rows.slice(0, k), moduli[k])
    return rows, x, consts, rng


# (acc lead shape, group): none, (c0, c1), c0, the batched fold's c0 of
# each ciphertext, one c0 for every ciphertext
LAYOUTS = {"none": (None, None), "c0c1": ((2,), None), "c0": ((1,), None),
           "fold": ((3, 1), 2), "fold_shared": ((1, 1), 2)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_fused_inverse_is_the_composition(n, layout):
    k, s = 3, 6
    rows, x, consts, rng = _case(n, k, s, SEED + n + len(layout))
    lead, group = LAYOUTS[layout]
    acc = None if lead is None else _t(_words(rng, rows.values[:k], lead, n))
    got = keyswitch.ntt_inverse_divide_round(x, rows, consts, acc, group)
    want = keyswitch.divide_round_last(ntt.rns_ntt_inverse(x, rows), consts,
                                       acc, group)
    assert torch.equal(got, want)
    assert torch.equal(got, keyswitch.ntt_inverse_divide_round_plain(
        x, rows, consts, acc, group))


@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_limb_shard_divides_its_rows(shard):
    """A shard of the limb axis (``_divide_by_special(limbs=)``) gives the
    rows of the whole divide, with the accumulator's rows of the shard."""
    n = 1024
    pctx, _ = _ctxs(n)
    cd, key_cd = pctx.first_context_data, pctx.key_context_data
    used = pev._used_tables(cd, key_cd)
    rng = np.random.default_rng(SEED + shard[0])
    prods = _t(_words(rng, used.values, (2,), n))
    acc = _t(_words(rng, cd.coeff_values, (2,), n))
    whole = pev._divide_by_special(prods, cd, key_cd, False, acc)
    assert torch.equal(whole, keyswitch.divide_round_last(
        ntt.rns_ntt_inverse(prods, used), keyswitch.divide_round_consts(
            cd.ntt, key_cd.coeff_values[-1]), acc))
    limbs = range(*shard)
    rows = list(limbs) + [cd.limbs]
    got = pev._divide_by_special(prods[:, rows], cd, key_cd, False,
                                 acc[:, limbs.start:limbs.stop],
                                 limbs=limbs)
    assert torch.equal(got, whole[:, limbs.start:limbs.stop])


def _key_words(rng, key_cd, n):
    return _words(rng, key_cd.coeff_values, (key_cd.limbs - 1, 2), n)


@pytest.mark.parametrize("n", [1024, 4096])
def test_bfv_key_switching_ops_match_troy_tpu(n):
    """relinearize and rotate_rows(1) of random coefficient-form BFV
    ciphertexts under random key words."""
    pctx, jctx = _ctxs(n)
    rng = np.random.default_rng(SEED + n)
    cd = pctx.first_context_data
    elt = 3                                   # rotate_rows by one step
    rlk = _key_words(rng, pctx.key_context_data, n)
    gk = _key_words(rng, pctx.key_context_data, n)
    pev_, jev_ = P.Evaluator(pctx), J.Evaluator(jctx)
    prlk = interop.relin_keys({2: rlk}, "cpu")
    jrlk = J.RelinKeys(keys={2: jnp.asarray(rlk)})
    pgk = interop.galois_keys({elt: gk}, "cpu")
    jgk = J.GaloisKeys(keys={elt: jnp.asarray(gk)})
    for name, size, op, pkeys, jkeys in (
            ("relinearize", 3, lambda e, c, keys: e.relinearize(c, keys),
             prlk, jrlk),
            ("rotate_rows", 2, lambda e, c, keys: e.rotate_rows(c, 1, keys),
             pgk, jgk)):
        words = _words(rng, cd.coeff_values, (size,), n)
        pct = interop.ciphertext(words, pctx.first_level, False, "cpu")
        jct = J.Ciphertext(data=jnp.asarray(words), level=jctx.first_level,
                           is_ntt_form=False)
        got, want = op(pev_, pct, pkeys), op(jev_, jct, jkeys)
        got_words, want_words = interop.to_numpy(got.data), np.asarray(
            want.data)
        assert got_words.shape == want_words.shape, name
        assert int((got_words != want_words).sum()) == 0, name


@pytest.mark.parametrize("use_mxu", [None, True])
def test_bfv_key_switch_route(use_mxu, monkeypatch):
    """On A's route a BFV key switch calls the fused divide once and F's
    divide never; on J's, A's inverse (J) and F's divide."""
    n = 4096 if use_mxu else 1024
    pctx, _ = _ctxs(n, use_mxu)
    calls = {"fused": 0, "divide": 0}
    fused, divide = (keyswitch.ntt_inverse_divide_round,
                     keyswitch.divide_round_last)

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(keyswitch, "ntt_inverse_divide_round",
                        count("fused", fused))
    monkeypatch.setattr(keyswitch, "divide_round_last",
                        count("divide", divide))
    rng = np.random.default_rng(SEED + 3)
    cd = pctx.first_context_data
    rlk = interop.relin_keys({2: _key_words(rng, pctx.key_context_data, n)},
                             "cpu")
    ct = interop.ciphertext(_words(rng, cd.coeff_values, (3,), n),
                            pctx.first_level, False, "cpu")
    P.Evaluator(pctx).relinearize(ct, rlk)
    assert calls == ({"fused": 1, "divide": 0} if use_mxu is None
                     else {"fused": 0, "divide": 1})


def test_fused_inverse_refuses_what_a_cannot_take():
    n = 2048
    moduli = [int(m) for m in P.CoeffModulus.create(n, [40, 40, 40])]
    on_a = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    on_j = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=True)
    consts = keyswitch.divide_round_consts(on_a.slice(0, 2), moduli[2])
    x = torch.zeros((2, 3, n), dtype=torch.int64)
    fn = keyswitch.ntt_inverse_divide_round
    with pytest.raises(ValueError, match="no transform on A"):
        fn(x, on_j, consts)
    with pytest.raises(ValueError, match="no transform on A"):
        fn(x, on_a.pointwise(n), consts)
    for bad in (x[:, :2], x[..., :64]):
        with pytest.raises(ValueError, match="do not fit"):
            fn(bad, on_a, consts)
    with pytest.raises(ValueError, match="do not fit"):
        fn(x, on_a, consts[:-1])
    with pytest.raises(ValueError, match="does not fit"):
        fn(x, on_a, consts, torch.zeros((3, 2, n), dtype=torch.int64))
    k = keyswitch.MAX_KERNEL_LIMBS + 1
    wide = numth.get_primes(128, 30, k + 1)       # past CoeffModulus's 64
    wt = ntt.RnsNttTables.from_moduli(64, wide, "cpu", use_mxu=False)
    with pytest.raises(ValueError, match="at most 64"):
        fn(torch.zeros((1, k + 1, 64), dtype=torch.int64), wt,
           keyswitch.divide_round_consts(wt.slice(0, k), wide[k]))


# --------------------------------------------------------------------------
# the fused pass's addressing, emulated
# --------------------------------------------------------------------------

def _constants():
    """kLogTile, kSplitLogN and the fused pass's caps as csrc/ntt.cu sets
    them."""
    src = (Path(ntt.__file__).resolve().parents[1] / "csrc"
           / "ntt.cu").read_text()

    def get(name):
        expr = re.search(rf"constexpr int {name} = ([0-9 <]+);", src).group(1)
        parts = [int(v) for v in expr.split("<<")]
        return parts[0] << parts[1] if len(parts) == 2 else parts[0]
    return {name: get(name) for name in (
        "kLogTile", "kSplitLogN", "kInverseThreads", "kInverseSmem",
        "kInverseMinBlocks", "kInverseConsts", "kWordsPerThread")}


def _inverse_plan(comps, k, log_n):
    """csrc/ntt.cu plan_inverse: (log_line, log_cols, group, log2 of a
    tile's threads, blocks) of the fused last pass."""
    c = _constants()
    if log_n < c["kSplitLogN"]:
        log_line, max_cols = log_n, 0
    else:
        a = log_n // 2
        log_line, max_cols = a, max(0, min(c["kLogTile"] - a, log_n - a))
    whole = None
    for cols in range(max_cols, min(max_cols, 1) - 1, -1):
        log_words = log_line + cols
        log_tt = max(0, log_words - 3)
        smem = lambda g: 8 * ((g + 1) * ((1 << log_words) + (2 << log_line))
                              + g * ((1 << log_words) + c["kInverseConsts"]))
        group = k
        while group > 1 and (group > (c["kInverseThreads"] >> log_tt) - 1
                             or smem(group) > c["kInverseSmem"]):
            group -= 1
        blocks = (comps * -(-k // group)) << (log_n - log_words)
        p = log_line, cols, group, log_tt, blocks
        if group == k:
            if blocks >= c["kInverseMinBlocks"]:
                return p
            whole = p
    return whole or p


def test_inverse_plans():
    """Every output row and the special row in one block where the caps
    allow it, the widest such column set with a block an SM (2 columns at
    (2, 6, n), 4 from (8, 6, n)), else groups of rows (SEAL's 15, 64
    limbs); within the card's limits (1024 threads, 227 KB of shared
    memory) at every n."""
    c = _constants()
    assert _inverse_plan(2, 5, 14)[1:3] == (1, 5)            # 2 columns
    for comps in (8, 256):
        assert _inverse_plan(comps, 5, 14)[1:3] == (2, 5)    # 4 columns
    assert _inverse_plan(2, 15, 15)[1:3] == (1, 9)           # SEAL's
    assert _inverse_plan(2, 5, 9)[1:3] == (0, 3)             # whole rows
    for comps, k, log_n in [(1, 64, 14), (2, 64, 17), (1, 1, 1), (2, 5, 9),
                            (2, 2, 24), (256, 64, 24)]:
        log_line, cols, group, log_tt, blocks = _inverse_plan(comps, k, log_n)
        assert 1 <= group <= k
        threads = (group + 1) << log_tt
        words = 1 << (log_line + cols)
        smem = 8 * ((group + 1) * (words + (2 << log_line))
                    + group * (words + c["kInverseConsts"]))
        assert threads <= 1024 and smem <= 232448
        words = 1 << (log_line + cols)
        assert words <= c["kWordsPerThread"] << log_tt   # a tile's loads
        assert group * words <= c["kWordsPerThread"] * threads   # finish


def _emulated_finish(v, acc, group, consts, rows, log_n):
    """The fused pass's loads and stores: block b = (comp, row group g,
    column set) holds columns first .. first + 2^log_cols of source rows
    comp (k+1) + j0 + t (tile t, j0 = g group) and comp (k+1) + k (the
    special tile); word f of a tile is column l = f mod 2^log_cols, line
    index i = f >> log_cols, at row offset first + l + (i << (log_n -
    log_line)); finished word F = t 2^log_words + f goes to output row comp
    k + j0 + t. v (s, k+1, n): the lazy words the butterflies leave (below
    2q), in source layout."""
    s, k = v.shape[0], v.shape[1] - 1
    n = 1 << log_n
    log_line, log_cols, G, _, blocks = _inverse_plan(s, k, log_n)
    log_words = log_line + log_cols
    log_sets = log_n - log_words
    groups = -(-k // G)
    b = torch.arange(blocks).unsqueeze(1)
    F = torch.arange(G << log_words)
    first = (b & ((1 << log_sets) - 1)) << log_cols
    cg = b >> log_sets
    comp, j0 = cg // groups, (cg % groups) * G
    t, f = F >> log_words, F & ((1 << log_words) - 1)
    l, i = f & ((1 << log_cols) - 1), f >> log_cols
    offset = first + l + (i << (log_n - log_line))
    j = (j0 + t).expand_as(offset)
    comp = comp.expand_as(offset)
    valid = j < k
    own = ((comp * (k + 1) + j) << log_n) + offset
    special = ((comp * (k + 1) + k) << log_n) + offset
    at = ((comp * k + j) << log_n) + offset
    assert torch.equal(torch.sort(at[valid]).values,
                       torch.arange((s * k) << log_n)), \
        "the fused pass does not store every word once"
    # a block's special tile is loaded once; its words stand at the first
    # output row's places
    loaded = torch.bincount(torch.cat([own[valid],
                                       special[:, :1 << log_words].flatten()]),
                            minlength=(s * (k + 1)) << log_n)
    per_row = loaded.reshape(s, k + 1, n)
    assert torch.all(per_row[:, :k] == 1) and \
        torch.all(per_row[:, k] == groups), \
        "row j's words are loaded once, row k's once a row group"
    own, special, at, j, comp = (x[valid] for x in (own, special, at, j,
                                                     comp))
    offset = offset.expand_as(valid)[valid]
    flat = v.flatten()
    q, nq, nq_sh = (getattr(rows, name)[j] for name in
                    ("q", "inv_degree", "inv_degree_shoup"))
    p, np_, np_sh = (int(getattr(rows, name)[k]) & u.M64 for name in
                     ("q", "inv_degree", "inv_degree_shoup"))
    x = u.reduce_2q(u.mul_mod_shoup_lazy(flat[own], nq, nq_sh, q), q)
    xk = u.reduce_2q(u.mul_mod_shoup_lazy(flat[special], np_, np_sh, p), p)
    ratio, half_mod, inv, inv_sh = (consts[o * k + j] for o in (1, 2, 3, 4))
    half = int(consts[5 * k + 1]) & u.M64
    last = u.add_mod(xk, half, p)
    temp = u.sub_mod(u.barrett_reduce_64(last, q, ratio), half_mod, q)
    word = u.mul_mod_shoup(u.sub_mod(x, temp, q), inv, inv_sh, q)
    acc4, a, group, groups_acc = keyswitch.accumulator_layout(
        acc, s, k, n, group, "emulated")
    if acc4 is not None:
        g, h = comp // group, comp % group
        arow = torch.where(h < a, (g % groups_acc) * a + h,
                           torch.full_like(h, -1))
        has = arow >= 0
        aw = acc4.flatten()[(((arow * k + j) << log_n) + offset)[has]]
        word[has] = u.add_mod(aw, word[has], q[has])
    out = torch.empty((s * k) << log_n, dtype=torch.int64)
    out[at] = word
    return out.reshape(s, k, n)


# n = 64: one pass over whole rows (compiled: 2^6-word lines); 512: one
# pass, run time (2^9-word lines); 1024-131072: compiled; 262144: run
# time; k = 48: the rows in groups, row k copied into each
@pytest.mark.parametrize("n,k,s", [(64, 3, 6), (512, 5, 2), (1024, 3, 6),
                                   (4096, 2, 6), (4096, 48, 2),
                                   (131072, 1, 2), (262144, 1, 2)])
def test_fused_pass_addressing_matches_the_plain_version(n, k, s):
    log_n = n.bit_length() - 1
    if k > 5:
        moduli = [int(m) for m in numth.get_primes(2 * n, 40, k)] + [
            int(numth.get_primes(2 * n, 60, 1)[0])]
    else:
        bits = [40] * k + ([55] if n > 4096 else [60])
        moduli = [int(m) for m in P.CoeffModulus.create(n, bits)]
    rows = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    consts = keyswitch.divide_round_consts(rows.slice(0, k), moduli[k])
    rng = np.random.default_rng(SEED + n + k)
    if k == 48:
        assert _inverse_plan(s, k, log_n)[2] < k          # row groups
    # the butterflies are A's own (their words are held to the plain
    # version on the card); lazy words below 2q stand in for them
    v = _t(_words(rng, [2 * q for q in moduli], (s,), n))
    col = lambda t: t.reshape(-1, 1)
    reduced = u.reduce_2q(u.mul_mod_shoup_lazy(
        v, col(rows.inv_degree), col(rows.inv_degree_shoup), col(rows.q)),
        col(rows.q))
    for lead, group in LAYOUTS.values():
        if lead is not None and lead[0] > s:
            continue
        acc = None if lead is None else _t(_words(rng, moduli[:k], lead, n))
        got = _emulated_finish(v, acc, group, consts, rows, log_n)
        assert torch.equal(got, keyswitch.divide_round_last_plain(
            reduced, consts, acc, group))
    if n <= 4096:
        # the whole fused divide: A's inverse rounds (no n^-1), then the
        # emulated finish, against the plain version of the wrapper
        x = _t(_words(rng, moduli, (s,), n))
        acc = _t(_words(rng, moduli[:k], (1,), n))
        got = _emulated_finish(_inverse_rounds(x, rows), acc, None, consts,
                               rows, log_n)
        assert torch.equal(got, keyswitch.ntt_inverse_divide_round_plain(
            x, rows, consts, acc))


def _inverse_rounds(x, rows):
    """The inverse butterfly network of ops/ntt.py without its n^-1 and
    final reduction: the lazy words (below 2q) a last pass finishes."""
    q = rows.q.reshape(-1, 1, 1)
    q2 = 2 * q
    v = x
    lead = x.shape[:-2]
    k, n = rows.k, rows.n
    for r in range(rows.log_n - 1, -1, -1):
        m = 1 << r
        gap = n >> (r + 1)
        w = rows.inv_root_powers[:, m:2 * m].reshape(k, m, 1)
        wq = rows.inv_root_powers_shoup[:, m:2 * m].reshape(k, m, 1)
        v = v.reshape(lead + (k, m, 2, gap))
        a, b = v[..., 0, :], v[..., 1, :]
        s = a + b
        d = a - b + q2
        s = torch.where(s >= q2, s - q2, s)
        bw = d * w - u.mulhi64(d, wq) * q
        v = torch.stack([s, bw], dim=-2).reshape(lead + (k, n))
    return v
