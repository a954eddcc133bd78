"""The app's ct x ct pair convolution folded into kernel A's first inverse
pass (AP2i, troy_tpu_torch/ops/ntt.py ``rns_ntt_inverse_pair_convolve``,
csrc/ntt.cu ``troy_ntt_inverse_pair_convolve``), and kernel P2's
redesigned grid (csrc/tiles.cu ``troy_tile_pair_convolve``), on the CPU,
word for word (tolerance 0):

  * AP2i's plain version against P2's plain version then A's inverse, at
    ciphertext sizes 1-4 a side, with lazy NTT-form words up to 4q - 1
    (the edge word 4q - 1 included), over q u Bsk of a BFV context;
  * the port's BFV ``_matmul_cipher_tiles_core`` (one AP2i call and one E
    tail an inner index on A's route) against troy_tpu/app/linear.py:133
    ``_matmul_cipher_pairs_core`` summed by :149 ``_acc_add`` over the
    inner index, at n = 64 over q = {40,40,40} (batching t) and q =
    {60,60,60} (t = 2^41, the app benchmark's);
  * the route: AP2i on A's route, P2 then J's inverse on J's
    (``use_mxu=True``), the same words; CKKS and BGV grids stay on P2;
  * the wrapper's refusals (J's tables, a pointwise view, a wrong shape,
    sizes above 4);
  * a plain-torch emulation of AP2i's first pass (its plan from csrc/
    ntt.cu, its block, tile and word maps) and of P2's grid (its block
    and thread maps, the constants read from csrc/tiles.cu): which a and
    w words each block loads, which output word each product is stored
    to, held to the plain version. The kernels cannot run here; this
    guards their addressing on the CPU.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu.app import linear as jlin
from test_torch_divide_fused import _geometry, _plan

import troy_tpu_torch as P
from troy_tpu_torch import evaluator as pev
from troy_tpu_torch import interop
from troy_tpu_torch.app import linear as plin
from troy_tpu_torch.ops import ntt, tiles
from troy_tpu_torch.ops import u64ops as u

torch.set_num_threads(2)

SEED = 7171
CONFIGS = {"40": (64, [40, 40, 40], None),
           "app": (64, [60, 60, 60], 1 << 41)}
CSRC = Path(ntt.__file__).resolve().parents[1] / "csrc"

_CTX = {}


def _ctxs(config, scheme="bfv", use_mxu=False):
    """(port context, troy_tpu context) of ``scheme`` at CONFIGS[config]
    (n = 2048 for the route's J tables)."""
    key = (config, scheme, use_mxu)
    if key not in _CTX:
        n, bits, t = CONFIGS[config] if config in CONFIGS \
            else (2048, [60, 60, 60], 1 << 41)
        out = []
        for mod in (P, J):
            kw = {}
            if scheme != "ckks":
                kw["plain_modulus"] = mod.PlainModulus.batching(n, 20) \
                    if t is None else mod.Modulus(t)
            parms = mod.EncryptionParameters(
                scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
                coeff_modulus=tuple(mod.CoeffModulus.create(n, bits)), **kw)
            on = ({"device": "cpu", "use_mxu": use_mxu} if mod is P
                  else {"use_mxu": False})
            out.append(mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                     **on))
        _CTX[key] = tuple(out)
    return _CTX[key]


def _words(rng, bounds, lead, n):
    return interop.to_torch(np.concatenate(
        [rng.integers(0, b, size=lead + (1, n), dtype=np.uint64)
         for b in bounds], axis=-2), "cpu")


def _lazy(rng, tables, lead):
    """Words below 4q, some at 4q - 1 exactly."""
    x = _words(rng, [4 * q for q in tables.values], lead, tables.n)
    edge = torch.tensor([4 * q - 1 for q in tables.values]).reshape(-1, 1)
    x[..., :3] = edge.to(torch.int64)
    return x


# --------------------------------------------------------------------------
# the fused wrapper and the callers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s1", [1, 2, 3, 4])
@pytest.mark.parametrize("s2", [1, 2, 4])
def test_fused_is_p2_then_the_inverse(s1, s2):
    pc, _ = _ctxs("app")
    qb = pc.first_context_data.rns.q_bsk
    rng = np.random.default_rng(SEED + 10 * s1 + s2)
    a, w = _lazy(rng, qb, (2, s1)), _lazy(rng, qb, (3, s2))
    want = ntt.rns_ntt_inverse(tiles.tile_pair_convolve_plain(a, w, qb), qb)
    got = ntt.rns_ntt_inverse_pair_convolve(a, w, qb)
    assert got.shape == (2, 3, s1 + s2 - 1, qb.k, qb.n)
    assert torch.equal(got, want)
    assert torch.equal(got, ntt.ntt_inverse_pair_convolve_plain(a, w, qb))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_bfv_cipher_tiles_core_matches_troy_tpu(config):
    """(I, X, 2, k, n) x (I, Yc, 2, k, n) coefficient-form tiles: the port's
    core against troy_tpu's pair core summed over the inner index."""
    pc, jc = _ctxs(config)
    pd, jd = pc.first_context_data, jc.first_context_data
    I, X, Yc = 2, 2, 3
    rng = np.random.default_rng(SEED + len(config))
    a = _words(rng, pd.ntt.values, (I, X, 2), pd.n)
    w = _words(rng, pd.ntt.values, (I, Yc, 2), pd.n)
    got = plin._matmul_cipher_tiles_core(a, w, pd)
    ja, jw = interop.to_numpy(a), interop.to_numpy(w)
    want = None
    for i in range(I):
        prod = jlin._matmul_cipher_pairs_core(jnp.asarray(ja[i]),
                                              jnp.asarray(jw[i]), jd)
        want = prod if want is None else jlin._acc_add(want, prod, jd)
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("use_mxu", [False, True], ids=["A", "J"])
def test_route_by_tables(monkeypatch, use_mxu):
    """BFV on A's route: one AP2i call, no P2; on J's (use_mxu=True at
    n = 2048): P2, then J's inverse; the same words. BGV stays on P2."""
    calls = {"fused": 0, "p2": 0}

    def counted(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapped)

    counted(ntt, "rns_ntt_inverse_pair_convolve", "fused")
    counted(tiles, "tile_pair_convolve", "p2")
    words = []
    for mxu in (use_mxu, not use_mxu):
        pd = _ctxs("route", "bfv", mxu)[0].first_context_data
        rng = np.random.default_rng(SEED + 3)
        qb = pd.rns.q_bsk
        a, w = _lazy(rng, qb, (1, 2)), _lazy(rng, qb, (2, 2))
        words.append(pev._pair_grid_multiply(a, w, pd))
    assert torch.equal(words[0], words[1])
    assert calls == {"fused": 1, "p2": 1}
    calls.update(fused=0, p2=0)
    pd = _ctxs("route", "bgv", False)[0].first_context_data
    rng = np.random.default_rng(SEED + 4)
    a, w = _lazy(rng, pd.ntt, (1, 2)), _lazy(rng, pd.ntt, (2, 2))
    pev._pair_grid_multiply(a, w, pd)
    assert calls == {"fused": 0, "p2": 1}


def test_fused_wrapper_refuses_what_a_cannot_take():
    pc, _ = _ctxs("40")
    qb = pc.first_context_data.rns.q_bsk
    a = torch.zeros((1, 2, qb.k, qb.n), dtype=torch.int64)
    with pytest.raises(ValueError, match="no transform on A"):
        ntt.rns_ntt_inverse_pair_convolve(a, a, qb.pointwise(qb.n))
    mxu = _ctxs("route", "bfv", True)[0].first_context_data.rns.q_bsk
    b = torch.zeros((1, 2, mxu.k, mxu.n), dtype=torch.int64)
    with pytest.raises(ValueError, match="no transform on A"):
        ntt.rns_ntt_inverse_pair_convolve(b, b, mxu)
    with pytest.raises(ValueError, match="expected"):
        ntt.rns_ntt_inverse_pair_convolve(a[..., :-1, :], a, qb)
    with pytest.raises(ValueError, match="expected"):
        ntt.rns_ntt_inverse_pair_convolve(a[0], a[0], qb)
    five = torch.zeros((1, 5, qb.k, qb.n), dtype=torch.int64)
    with pytest.raises(ValueError, match="at most 4"):
        ntt.rns_ntt_inverse_pair_convolve(five, a, qb)
    with pytest.raises(ValueError, match="at most 4"):
        tiles.tile_pair_convolve(a, five, qb)


# --------------------------------------------------------------------------
# the kernels' addressing, emulated
# --------------------------------------------------------------------------

def _products(a_words, w_words, s1, s2, m, tables_q, lo, hi):
    """P2's arithmetic on gathered words: sum_{i + i' = m} a_i w_i' in 128
    bits, one Barrett-128."""
    acc_lo = acc_hi = None
    for i in range(s1):
        if 0 <= m - i < s2:
            plo, phi = u.mul128(a_words[i], w_words[m - i])
            acc_lo, acc_hi = (plo, phi) if acc_lo is None else \
                u.add_u128(acc_lo, acc_hi, plo, phi)
    return u.barrett_reduce_128(acc_lo, acc_hi, tables_q, lo, hi)


def _first_inverse_pass(log_n):
    """(log_line, log_lines) of AP2i's fused pass: A's contiguous lines
    from 2^kSplitLogN (the inverse transform's first pass), as many a block
    as 2^kPairLogTile words hold (at least one), one chunk of the whole row
    below."""
    log_tile, split = _geometry()
    src = (CSRC / "ntt.cu").read_text()
    log_pair_tile = log_tile - int(re.search(
        r"constexpr int kPairLogTile = kLogTile - (\d+);", src).group(1))
    if log_n < split:
        return log_n, 0
    _, log_line, log_lines, _ = _plan(log_n)[1]
    return log_line, max(0, min(log_lines, log_pair_tile - log_line))


def _emulated_pair_pass(a, w, tables):
    """AP2i's first pass before its butterflies: block (pair p = x Y + y,
    chunk set) of row r loads a[x, i, r] and w[y, i', r] at the set's
    words pos0 + f and stores product m to output row ((p so + m) R + r)
    at the same words."""
    X, s1, R, n = a.shape
    Y, s2 = w.shape[0], w.shape[1]
    so = s1 + s2 - 1
    log_n = n.bit_length() - 1
    log_line, log_lines = _first_inverse_pass(log_n)
    log_words = log_line + log_lines
    log_sets = log_n - log_words
    src = (CSRC / "ntt.cu").read_text()
    threads = int(re.search(r"constexpr int kPairThreads = (\d+);",
                            src).group(1))
    assert so * 32 <= threads
    out = torch.full((X * Y * so * R << log_n,), -1, dtype=torch.int64)
    af, wf = a.flatten(), w.flatten()
    for bx in range((X * Y) << log_sets):
        sset, pair = bx & ((1 << log_sets) - 1), bx >> log_sets
        x, y = pair // Y, pair % Y
        pos = (sset << log_words) + torch.arange(1 << log_words)
        for r in range(R):
            a_at = [((x * s1 + i) * R + r) * n + pos for i in range(s1)]
            w_at = [((y * s2 + i) * R + r) * n + pos for i in range(s2)]
            col = lambda name: getattr(tables, name)[r]
            for m in range(so):
                at = ((pair * so + m) * R + r) * n + pos
                assert bool((out[at] == -1).all()), "a word stored twice"
                out[at] = _products([af[i] for i in a_at],
                                    [wf[i] for i in w_at], s1, s2, m,
                                    col("q"), col("cr_lo"), col("cr_hi"))
    assert bool((out != -1).all()), "a word never stored"
    return out.reshape(X, Y, so, R, n)


# n = 64: the one pass (a whole row a block); 2048: a compiled contiguous
# geometry (2^6-word chunks, 16 a block); 262144: the run-time one
@pytest.mark.parametrize("n,s1,s2", [(64, 2, 2), (2048, 3, 2),
                                     (2048, 1, 4), (262144, 2, 1)])
def test_fused_pass_addressing_matches_the_plain_version(n, s1, s2):
    moduli = [int(v) for v in P.CoeffModulus.create(n, [60, 40])]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    rng = np.random.default_rng(SEED + n + s1)
    X, Y = (1, 1) if n > 4096 else (2, 3)
    a, w = _lazy(rng, tables, (X, s1)), _lazy(rng, tables, (Y, s2))
    prods = _emulated_pair_pass(a, w, tables)
    assert torch.equal(prods, tiles.tile_pair_convolve_plain(a, w, tables))
    if n <= 4096:
        assert torch.equal(ntt.rns_ntt_inverse(prods, tables),
                           ntt.rns_ntt_inverse_pair_convolve(a, w, tables))


def _p2_constants():
    src = (CSRC / "tiles.cu").read_text()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                     src).group(1))
    return get("kPairThreads"), get("kPairTileY")


@pytest.mark.parametrize("n,X,Y", [(64, 2, 5), (1024, 1, 16), (2, 3, 4)])
def test_p2_grid_addressing_matches_the_plain_version(n, X, Y):
    """P2's grid: block (x y_tiles + y tile) 2^log_cblocks + coefficient
    block of row r; a thread's coefficients j, j + 1; its x's words and
    its tile's ny outputs y."""
    threads, tile_y = _p2_constants()
    moduli = [int(v) for v in P.CoeffModulus.create(max(n, 64), [40, 60])]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False) \
        if n >= 64 else None
    s1, s2 = 2, 3
    so = s1 + s2 - 1
    R = 2
    log_n = n.bit_length() - 1
    log_cblocks = max(log_n - (1 + (threads.bit_length() - 1)), 0)
    y_tiles = -(-Y // tile_y)
    rng = np.random.default_rng(SEED + n + Y)
    bounds = [4 * q for q in moduli]
    a = _words(rng, bounds, (X, s1), n)
    w = _words(rng, bounds, (Y, s2), n)
    out = torch.full((X * Y * so * R * n,), -1, dtype=torch.int64)
    af, wf = a.flatten(), w.flatten()
    q = u.u64(moduli)
    lo = u.u64([((1 << 128) // v) & u.M64 for v in moduli])
    hi = u.u64([(1 << 128) // v >> 64 for v in moduli])
    for bx in range((X * y_tiles) << log_cblocks):
        cb, xt = bx & ((1 << log_cblocks) - 1), bx >> log_cblocks
        x, y0 = xt // y_tiles, (xt % y_tiles) * tile_y
        ny = min(Y - y0, tile_y)
        j = (cb * threads + torch.arange(threads)) * 2
        j = j[j < n]
        j = torch.cat([j, j + 1])
        for r in range(R):
            at = r * n + j
            av = [af[(x * s1 + i) * R * n + at] for i in range(s1)]
            for t in range(ny):
                wv = [wf[((y0 + t) * s2 + i) * R * n + at]
                      for i in range(s2)]
                for m in range(so):
                    o = ((x * Y + y0 + t) * so + m) * R * n + at
                    assert bool((out[o] == -1).all()), "a word stored twice"
                    out[o] = _products(av, wv, s1, s2, m, q[r], lo[r],
                                       hi[r])
    assert bool((out != -1).all()), "a word never stored"
    if tables is not None:
        assert torch.equal(out.reshape(X, Y, so, R, n),
                           tiles.tile_pair_convolve_plain(a, w, tables))
