"""Kernel O1's shared-memory FFT passes (and O5's residual on them),
emulated in plain PyTorch on the CPU.

csrc/embedding.cu runs the 4-step transform n = A x B as two passes of
radix-2 decimation-in-frequency FFTs: pass 1 over blocks of COLS columns
(lines of A words, root w^B), pass 2 over the row pairs (p1, A-1-p1)
(lines of B words, root w^A), each line in a padded line-major tile, the
rounds in stages of up to LOG_RADIX in registers with the round-major root
tables of ``embedding.line_roots``. The emulation below makes the kernel's
index arithmetic step for step (stage plan, groups, gaps, twiddle indices,
padded positions, bit-reversed stores, the slot scatter, the in-block
partners and the residual) and is held, at every power-of-two n from 2 to
4096 and at each radix and column count the kernel can be built with, to
the plain version (``_four_step_plain``) and to troy_tpu's
``embed_inverse`` and ``embed_forward`` within 2^-44 max|want| (two FP64
summation orders); its residual is the exact ``conj_residual`` of its own
slots and partners, and above 0.
"""

import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from troy_tpu.ops import embedding as jemb

from troy_tpu_torch.ops import embedding as emb

torch.set_num_threads(1)

NS = [2 ** e for e in range(1, 13)]
TOL = 2.0 ** -44
SOURCE = (Path(emb.__file__).resolve().parent.parent / "csrc"
          / "embedding.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def spos(f):
    """The kernel's padded shared-memory position (one pad word in 8)."""
    return f + (f >> 3)


def brv(i: torch.Tensor, log: int) -> torch.Tensor:
    out = torch.zeros_like(i)
    for b in range(log):
        out |= ((i >> b) & 1) << (log - 1 - b)
    return out


def stage_plan(s: int, log_line: int, log_radix: int):
    stages = -(-log_line // log_radix)
    small, extra = divmod(log_line, stages)
    return small + (1 if s < extra else 0), s * small + min(s, extra)


def fft_lines(tile: torch.Tensor, roots: torch.Tensor, log_line: int,
              lines: int, log_radix: int) -> None:
    """fft_lines of the kernel on every block's tile (blocks, padded
    words), in place."""
    L = 1 << log_line
    for s in range(-(-log_line // log_radix)):
        R, rho0 = stage_plan(s, log_line, log_radix)
        log_groups, log_h = log_line - R, log_line - rho0 - R
        it = torch.arange(lines << log_groups)
        l, g = it >> log_groups, it & ((1 << log_groups) - 1)
        base = ((l << log_line) | ((g >> log_h) << (log_line - rho0))
                | (g & ((1 << log_h) - 1)))
        low = base & ((1 << log_h) - 1)
        pos = [spos(base + (m << log_h)) for m in range(1 << R)]
        v = [tile[:, p] for p in pos]
        for t in range(R):
            rho, d = rho0 + t, 1 << (R - 1 - t)
            round_ = roots[L - (L >> rho):]
            for m in range(1 << R):
                if m & d:
                    continue
                w = round_[low | ((m & (d - 1)) << log_h)]
                a, b = v[m], v[m + d]
                v[m], v[m + d] = a + b, (a - b) * w
        for m, p in enumerate(pos):
            tile[:, p] = v[m]


def columns_pass(x: torch.Tensor, tw: torch.Tensor, roots: torch.Tensor,
                 A: int, B: int, cols: int, log_radix: int) -> torch.Tensor:
    """fft_cols_kernel: s[p1, b] = tw[p1, b] FFT(x[., b])[p1], (n,)."""
    log_a = A.bit_length() - 1
    C = cols if log_a >= 2 else 1
    W = A * C
    f = torch.arange(W)
    l, a = f & (C - 1), f // C
    b0 = (torch.arange(B // C) * C).reshape(-1, 1)
    tile = torch.zeros(B // C, W + W // 8, dtype=torch.complex128)
    tile[:, spos(l * A + a)] = x[a * B + b0 + l]
    fft_lines(tile, roots, log_a, C, log_radix)
    at = brv(f // C, log_a) * B + b0 + l
    s = torch.empty(A * B, dtype=torch.complex128)
    s[at] = tile[:, spos(l * A + f // C)] * tw.reshape(-1)[at]
    return s


def rows_pass(s: torch.Tensor, roots: torch.Tensor, A: int, B: int,
              log_radix: int, t: "emb.EmbedTables", encode: bool):
    """fft_rows_kernel on the row pairs (p1, A-1-p1): encode, u (n,) =
    FFT / n; decode, (slots, partners, residual, the partner each slot's
    block read)."""
    log_b = B.bit_length() - 1
    W = 2 * B
    f = torch.arange(W)
    l, i = f >> log_b, f & (B - 1)
    p1 = torch.arange(A // 2).reshape(-1, 1)
    rows = torch.where(l == 0, p1, A - 1 - p1)              # (A/2, W)
    tile = torch.zeros(A // 2, W + W // 8, dtype=torch.complex128)
    tile[:, spos(f)] = s[rows * B + i]
    fft_lines(tile, roots, log_b, 2, log_radix)
    k = brv(i, log_b) * A + rows
    v = tile[:, spos(f)]
    n = A * B
    if encode:
        out = torch.empty(n, dtype=torch.complex128)
        out[k] = v * (1.0 / n)
        return out
    slot = t.scatter.to(torch.int64)[k]
    mine = slot >= 0
    slots = torch.empty(n // 2, dtype=torch.complex128)
    partners = torch.empty_like(slots)
    slots[slot[mine]] = v[mine]
    partners[~slot[~mine]] = v[~mine]
    # n-1-k: the other line of the block, word B-1-p2
    p = tile[:, spos(((l ^ 1) << log_b) + (B - 1 - i))]
    read = torch.empty_like(slots)
    read[slot[mine]] = p[mine]
    each = torch.maximum((v.real - p.real).abs(), (v.imag + p.imag).abs())
    residual = torch.where(mine, each, torch.zeros_like(each)).amax(dim=1)
    return slots, partners, residual.max(), read


def emulate_encode(values, t, cols, log_radix):
    x = emb.scatter_slots(values, t)
    s = columns_pass(x, t.twe, t.roots_ae, t.a, t.b, cols, log_radix)
    return rows_pass(s, t.roots_be, t.a, t.b, log_radix, t, True)


def emulate_decode(coeffs, t, cols, log_radix):
    s = columns_pass(coeffs * t.twist, t.twd, t.roots_ad, t.a, t.b, cols,
                     log_radix)
    return rows_pass(s, t.roots_bd, t.a, t.b, log_radix, t, False)


@lru_cache(maxsize=None)
def _inputs(n: int):
    rng = np.random.default_rng(n + 13)
    vals = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    coeffs = rng.uniform(-1, 1, n) * 2.0 ** 20
    return vals, coeffs


@jax.jit
def _troy_tpu(v_re, v_im, coeffs, jt):
    return jemb.embed_inverse(v_re, v_im, jt), jemb.embed_forward(coeffs, jt)


@lru_cache(maxsize=None)
def _troy_tpu_outputs(n: int):
    """troy_tpu's real coefficients of the encode and slots of the decode,
    one compile per n."""
    vals, coeffs = _inputs(n)
    t = emb.make_embed_tables(n, "cpu")
    v = emb.scatter_slots(torch.from_numpy(vals), t).numpy()
    enc, (re, im) = _troy_tpu(v.real, v.imag, coeffs,
                              jemb.make_embed_tables(n))
    return np.asarray(enc), np.asarray(re) + 1j * np.asarray(im)


def _close(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_the_kernel_is_built_as_emulated():
    """The constants the emulation is parametrised over are the kernel's."""
    assert _constant("LOG_RADIX") in (1, 2, 3)
    assert _constant("COLS") in (1, 2, 4)
    assert _constant("MAX_LOG_LINE") == 9        # A, B <= 512: n <= 2^18


@pytest.mark.parametrize("n", NS)
def test_root_tables_are_the_plain_versions_entries(n):
    """Round r's root j of each line length is the plain version's dense
    matrix entry w1[1, j 2^r] (length A) or w2[1, j 2^r] (length B), bit
    for bit, in both directions."""
    t = emb.make_embed_tables(n, "cpu")
    for L, dense, roots in ((t.a, (t.w1e, t.w1d), (t.roots_ae, t.roots_ad)),
                            (t.b, (t.w2e, t.w2d), (t.roots_be, t.roots_bd))):
        assert roots[0].shape == (max(L - 1, 1),)
        log = L.bit_length() - 1
        for r in range(log):
            j = torch.arange(L >> (r + 1))
            for m, table in zip(dense, roots):
                assert torch.equal(table[L - (L >> r) + j], m[1, j << r])


@pytest.mark.parametrize("log_radix", [1, 2, 3])
@pytest.mark.parametrize("n", NS)
def test_emulated_passes_against_plain_and_troy_tpu(n, log_radix):
    t = emb.make_embed_tables(n, "cpu")
    vals, coeffs = _inputs(n)
    vals_t, coeffs_t = torch.from_numpy(vals), torch.from_numpy(coeffs)
    want_enc, want_dec = _troy_tpu_outputs(n)
    plain_u = emb.embed_inverse_fft_plain(vals_t, t)
    pslots, ppartners, _ = emb.embed_forward_stats_plain(coeffs_t, t)
    for cols in sorted({1, 2, _constant("COLS")}):
        u = emulate_encode(vals_t, t, cols, log_radix)
        _close(u, plain_u)
        _close((u * t.untwist).real, want_enc)
        # a partial slot vector: the scatter's zeros past the count
        few = vals_t[:3] if n >= 8 else vals_t[:1]
        _close(emulate_encode(few, t, cols, log_radix),
               emb.embed_inverse_fft_plain(few, t))
        slots, partners, residual, read = emulate_decode(coeffs_t, t, cols,
                                                         log_radix)
        _close(slots, pslots)
        _close(slots, want_dec)
        _close(partners, ppartners)
        # every slot's block held its partner: the residual is the exact
        # conj_residual of the stored slots and partners
        assert torch.equal(read, partners)
        assert torch.equal(residual, emb.conj_residual(slots, partners))
        assert float(residual) > 0


@pytest.mark.parametrize("n", [64, 4096])
def test_emulated_decode_of_an_encoding_is_its_slots(n):
    """A decode's residual in slot units: the real coefficients of an
    encoding decode to its slots, with a residual in (0, 1e-8]."""
    t = emb.make_embed_tables(n, "cpu")
    vals = torch.from_numpy(_inputs(n)[0])
    u = emulate_encode(vals, t, _constant("COLS"), _constant("LOG_RADIX"))
    slots, _, residual, _ = emulate_decode((u * t.untwist).real, t,
                                           _constant("COLS"),
                                           _constant("LOG_RADIX"))
    assert float((slots - vals).abs().max()) <= 1e-12
    assert 0.0 < float(residual) <= 1e-8
