"""The plain versions of kernels P1-P3 (troy_tpu_torch/ops/tiles.py) against
troy_tpu's jitted app cores, word for word (tolerance 0), on the CPU.

BFV, CKKS and BGV contexts at n = 64, q = {40,40,40} (two data limbs),
random words below each limb's modulus from numpy seeds:
  * P1 ``tile_contract`` against troy_tpu/app/linear.py:43
    ``_matmul_tiles_core`` on NTT-form tiles, with I = 70 inner tiles (past
    the 128-bit sum's 64-term reduction) and I = 3; the port's whole
    ``_matmul_tiles_core`` (BFV coefficient-form tiles, mod-t weights)
    against the JAX one;
  * P2 ``tile_pair_convolve`` against linear.py:133
    ``_matmul_cipher_pairs_core`` (CKKS and BGV: the NTT-form convolution
    alone; BFV: through ``_bfv_lift_ntt`` and ``_pair_grid_multiply``, the
    lift, P2, the inverse NTT and the BEHZ tail), sizes 2 x 2 and 3 x 2;
  * P3 ``pack_group_fold`` against linear.py:237 ``_pack_group_fold_core``
    at m = 16 and a ragged m = 20 with P = 16, m = 5 with P = 2, and P = 1;
  * an emulation of P1's tiled kernel (csrc/tiles.cu, its tile sizes and
    ring depth read from the source): its blocks in the kernel's order,
    each a limb, a coefficient tile and a tile of outputs y (the ragged
    last one masked), the inner indices through the ring of cp.async slots
    and the 128-bit sums folded every FOLD_TERMS terms, against
    ``tile_contract_plain`` and ``_matmul_tiles_core`` at ragged Y (5, 13,
    52), I in {1, 63, 64, 127} (across the fold), C in {2, 3, 4} and
    X in {1, 3}.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu.app import linear as jlin

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch.app import linear as tlin
from troy_tpu_torch.evaluator import _bfv_lift_ntt, _pair_grid_multiply
from troy_tpu_torch.ops import tiles
from troy_tpu_torch.ops import u64ops as u

torch.set_num_threads(2)

N = 64
SEED = 4411


def _ctx(mod, scheme):
    extra = {} if scheme == "ckks" else {
        "plain_modulus": mod.PlainModulus.batching(N, 20)}
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=N,
        coeff_modulus=tuple(mod.CoeffModulus.create(N, [40, 40, 40])),
        **extra)
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)


_CTX = {}


def _cds(scheme):
    if scheme not in _CTX:
        _CTX[scheme] = (_ctx(P, scheme).first_context_data,
                        _ctx(J, scheme).first_context_data)
    return _CTX[scheme]


def _words(rng, moduli, shape):
    """Words below modulus l in limb l of a (..., k, n) shape."""
    cols = [rng.integers(0, q, size=shape[:-2] + (1, shape[-1]),
                         dtype=np.uint64) for q in moduli]
    return np.concatenate(cols, axis=-2)


def _equal(port: torch.Tensor, ref) -> None:
    got, want = interop.to_numpy(port), np.asarray(ref)
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0, "words differ"


@pytest.mark.parametrize("X,I,Y", [(1, 70, 3), (2, 3, 4)])
def test_tile_contract_plain_matches_troy_tpu(X, I, Y):
    tcd, jcd = _cds("bgv")
    rng = np.random.default_rng(SEED + I)
    a = _words(rng, tcd.coeff_values, (X, I, 2, tcd.limbs, N))
    w = _words(rng, tcd.coeff_values, (I, Y, tcd.limbs, N))
    got = tiles.tile_contract(interop.to_torch(a, "cpu"),
                              interop.to_torch(w, "cpu"), tcd.ntt)
    _equal(got, jlin._matmul_tiles_core(jnp.asarray(a), jnp.asarray(w), jcd,
                                        False, False))


def test_matmul_tiles_core_coefficient_form_mod_t_weights():
    """BFV: coefficient-form ciphertext tiles (A forward and back around
    P1) and mod-t weight tiles (G' and A)."""
    tcd, jcd = _cds("bfv")
    rng = np.random.default_rng(SEED + 1)
    a = _words(rng, tcd.coeff_values, (2, 5, 2, tcd.limbs, N))
    t = int(tcd.plain_modulus)
    w = rng.integers(0, t, (5, 3, N), dtype=np.uint64)
    got = tlin._matmul_tiles_core(interop.to_torch(a, "cpu"),
                                  interop.to_torch(w, "cpu"), tcd, True, True)
    _equal(got, jlin._matmul_tiles_core(jnp.asarray(a), jnp.asarray(w), jcd,
                                        True, True))


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
@pytest.mark.parametrize("s1", [2, 3])
def test_pair_grid_matches_troy_tpu(scheme, s1):
    """P2 on the X x Yc grid of one contraction step (X = 2, Yc = 3)."""
    tcd, jcd = _cds(scheme)
    rng = np.random.default_rng(SEED + s1)
    a = _words(rng, tcd.coeff_values, (2, s1, tcd.limbs, N))
    w = _words(rng, tcd.coeff_values, (3, 2, tcd.limbs, N))
    ta, tw = interop.to_torch(a, "cpu"), interop.to_torch(w, "cpu")
    if scheme == "bfv":
        ta, tw = _bfv_lift_ntt(ta, tcd), _bfv_lift_ntt(tw, tcd)
    got = _pair_grid_multiply(ta, tw, tcd)
    assert got.shape == (2, 3, s1 + 1, tcd.limbs, N)
    _equal(got, jlin._matmul_cipher_pairs_core(jnp.asarray(a),
                                               jnp.asarray(w), jcd))


def test_pair_convolve_lazy_inputs():
    """Words below 4q, as the BFV lift's lazy transform gives them: the
    same residues as the reduced words."""
    tcd, _ = _cds("bfv")
    qb = tcd.rns.q_bsk
    rng = np.random.default_rng(SEED + 9)
    a = _words(rng, qb.values, (2, 2, qb.k, N))
    w = _words(rng, qb.values, (3, 2, qb.k, N))
    lazy = lambda x, m: x + np.uint64(m) * np.array(
        qb.values, dtype=np.uint64).reshape(-1, 1)
    want = tiles.tile_pair_convolve(interop.to_torch(a, "cpu"),
                                    interop.to_torch(w, "cpu"), qb)
    got = tiles.tile_pair_convolve(interop.to_torch(lazy(a, 3), "cpu"),
                                   interop.to_torch(lazy(w, 2), "cpu"), qb)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,slots", [(16, 16), (20, 16), (5, 2), (3, 1)])
def test_group_fold_plain_matches_troy_tpu(m, slots):
    tcd, jcd = _cds("bfv")
    rng = np.random.default_rng(SEED + m)
    data = _words(rng, tcd.coeff_values, (m, 2, tcd.limbs, N))
    got = tiles.pack_group_fold(interop.to_torch(data, "cpu"), slots,
                                tcd.ntt)
    assert got.shape[0] == -(-m // slots)
    _equal(got, jlin._pack_group_fold_core(jnp.asarray(data), jcd, slots))


def test_wrappers_refuse_bad_shapes():
    tcd, _ = _cds("bfv")
    q = tcd.ntt
    k = tcd.limbs
    z = lambda *s: torch.zeros(s, dtype=torch.int64)
    with pytest.raises(ValueError):
        tiles.tile_contract(z(1, 3, 2, k, N), z(2, 1, k, N), q)
    with pytest.raises(ValueError):
        tiles.tile_pair_convolve(z(1, 5, k, N), z(1, 2, k, N), q)
    with pytest.raises(ValueError):
        tiles.pack_group_fold(z(4, 2, k, N), N + 1, q)


def _p1_geometry():
    """(kTileJ, kTileY, kStages, FOLD_TERMS) as csrc/tiles.cu sets them."""
    src = (Path(tiles.__file__).resolve().parents[1] / "csrc"
           / "tiles.cu").read_text()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                     src).group(1))
    return get("kTileJ"), get("kTileY"), get("kStages"), get("FOLD_TERMS")


def _p1_blocks(a, w, t, tile_j, tile_y, stages, fold_terms):
    """P1's tiled kernel, block by block in plain torch: block b is (y
    tile, x, coefficient tile, limb) with the y tile fastest; a thread's
    words of inner index i land in ring slot i % stages, fetched stages - 1
    indices ahead; the kTileY x C sums of a coefficient are 128-bit and
    folded by Barrett-128 every fold_terms terms and at the end; the
    masked weights of a ragged y tile count as 0 and are not stored."""
    X, I, C, k, n = a.shape
    Y = w.shape[1]
    y_tiles, j_tiles = -(-Y // tile_y), -(-n // tile_j)
    out = torch.full((X, Y, C, k, n), -1, dtype=torch.int64)
    for b in range(y_tiles * X * j_tiles * k):
        yt, r = b % y_tiles, b // y_tiles
        x, r = r % X, r // X
        l = r // j_tiles
        j0 = (r - l * j_tiles) * tile_j
        j1 = min(n, j0 + tile_j)
        y0 = yt * tile_y
        ny = min(tile_y, Y - y0)
        q, q_lo, q_hi = t.q[l], t.cr_lo[l], t.cr_hi[l]
        ring = [None] * stages

        def fetch(i):
            if i < I:
                wv = torch.zeros((tile_y, j1 - j0), dtype=torch.int64)
                wv[:ny] = w[i, y0:y0 + ny, l, j0:j1]
                ring[i % stages] = (i, a[x, i, :, l, j0:j1], wv)

        for i in range(stages - 1):
            fetch(i)
        lo = hi = torch.zeros((tile_y, C, j1 - j0), dtype=torch.int64)
        pending = 0
        for i in range(I):
            fetch(i + stages - 1)
            got_i, av, wv = ring[i % stages]
            assert got_i == i, "a ring slot was overwritten before its read"
            plo, phi = u.mul128(wv[:, None], av[None])
            lo, hi = u.add_u128(lo, hi, plo, phi)
            pending += 1
            if pending == fold_terms:
                lo = u.barrett_reduce_128(lo, hi, q, q_lo, q_hi)
                hi, pending = torch.zeros_like(lo), 0
        res = u.barrett_reduce_128(lo, hi, q, q_lo, q_hi)
        out[x, y0:y0 + ny, :, l, j0:j1] = res[:ny]
    assert not bool((out == -1).any()), "an output word was never written"
    return out


@pytest.mark.parametrize("X,I,Y,C", [(1, 1, 5, 2), (3, 63, 13, 3),
                                     (1, 64, 52, 2), (3, 127, 5, 4),
                                     (1, 127, 13, 2), (3, 64, 52, 3),
                                     (1, 63, 5, 4), (3, 1, 13, 4)])
def test_tiled_p1_blocks_match_plain_and_troy_tpu(X, I, Y, C):
    tcd, jcd = _cds("bgv")
    rng = np.random.default_rng(SEED + 100 * X + I + Y + C)
    a = _words(rng, tcd.coeff_values, (X, I, C, tcd.limbs, N))
    w = _words(rng, tcd.coeff_values, (I, Y, tcd.limbs, N))
    ta, tw = interop.to_torch(a, "cpu"), interop.to_torch(w, "cpu")
    tile_j, tile_y, stages, fold_terms = _p1_geometry()
    got = _p1_blocks(ta, tw, tcd.ntt, tile_j, tile_y, stages, fold_terms)
    assert torch.equal(got, tiles.tile_contract_plain(ta, tw, tcd.ntt))
    _equal(got, jlin._matmul_tiles_core(jnp.asarray(a), jnp.asarray(w), jcd,
                                        False, False))


@pytest.mark.parametrize("tile_j,tile_y,stages", [(16, 3, 2), (32, 5, 3)])
def test_tiled_p1_blocks_over_several_coefficient_tiles(tile_j, tile_y,
                                                        stages):
    """The same decomposition with tiles smaller than the ring of n = 64
    words and other y tiles and ring depths: the words do not depend on
    the geometry."""
    tcd, _ = _cds("bgv")
    rng = np.random.default_rng(SEED + tile_j)
    a = interop.to_torch(_words(rng, tcd.coeff_values,
                                (2, 70, 2, tcd.limbs, N)), "cpu")
    w = interop.to_torch(_words(rng, tcd.coeff_values,
                                (70, 7, tcd.limbs, N)), "cpu")
    got = _p1_blocks(a, w, tcd.ntt, tile_j, tile_y, stages,
                     _p1_geometry()[3])
    assert torch.equal(got, tiles.tile_contract_plain(a, w, tcd.ntt))
