"""The app layer's tile contractions: kernels P1-P3 (csrc/tiles.cu).

The port of the jitted cores of troy_tpu/app/linear.py:
  * ``tile_contract`` (P1, linear.py:43 _matmul_tiles_core): the ct x pt
    fan-out of the coefficient-packed matmul and conv2d, out[x, y] =
    sum_i a[x, i] w[i, y] in the NTT domain, one launch for every tile;
  * ``tile_pair_convolve`` (P2, linear.py:133 _matmul_cipher_pairs_core):
    the ciphertext-degree convolution of every (x, y) pair of an X x Yc
    grid of NTT-form tiles, one launch (CKKS and BGV, and BFV on J's
    route; on A's route BFV's grid runs P2 inside A's first inverse pass,
    ops/ntt.py ``rns_ntt_inverse_pair_convolve``);
  * ``pack_group_fold`` (P3, linear.py:237 _pack_group_fold_core): each
    group of P traced ciphertexts folded into one with per-member monomial
    shifts, one launch.
Each wrapper runs its plain PyTorch version for tensors on the CPU and
launches its kernel for tensors on CUDA. Words are int64 tensors of u64
bit patterns; tables are the RnsNttTables of the rows' moduli.
"""

from __future__ import annotations

import torch

from . import u64ops as u
from .. import _kernels
from .ntt import RnsNttTables, _check_pair, _check_rows, _col
from .poly import negacyclic_shift_plain

# Products of reduced words (< 2^61) summed in 128 bits before a reduction.
_CHUNK = 64
# Ciphertext components a kernel takes.
MAX_COMPS = 4


def _reduced_sum(pairs, t: RnsNttTables, lead: int) -> torch.Tensor:
    """sum of a * b over the (a, b) pairs mod q per limb: 128-bit sums of
    at most _CHUNK products, each Barrett-reduced, added mod q."""
    q = _col(t.q, lead, 1)
    lo_q, hi_q = _col(t.cr_lo, lead, 1), _col(t.cr_hi, lead, 1)
    acc = None
    for c0 in range(0, len(pairs), _CHUNK):
        lo = hi = None
        for a, b in pairs[c0:c0 + _CHUNK]:
            plo, phi = u.mul128(a, b)
            lo, hi = (plo, phi) if lo is None else u.add_u128(lo, hi, plo,
                                                              phi)
        part = u.barrett_reduce_128(lo, hi, q, lo_q, hi_q)
        acc = part if acc is None else u.add_mod(acc, part, q)
    return acc


def tile_contract_plain(a: torch.Tensor, w: torch.Tensor,
                        t: RnsNttTables) -> torch.Tensor:
    """The plain version of P1: a (X, I, C, k, n), w (I, Y, k, n), reduced
    words -> (X, Y, C, k, n), fully reduced."""
    pairs = [(a[:, i].unsqueeze(1), w[i].unsqueeze(0).unsqueeze(2))
             for i in range(a.shape[1])]
    return _reduced_sum(pairs, t, 3)


def tile_contract(a: torch.Tensor, w: torch.Tensor,
                  t: RnsNttTables) -> torch.Tensor:
    """out[x, y, c] = sum_i a[x, i, c] * w[i, y] mod q per limb (kernel P1,
    one launch): a (X, I, C, k, n) ciphertext tiles, w (I, Y, k, n)
    plaintext tiles, both NTT form with words below q; out (X, Y, C, k, n),
    fully reduced."""
    _check_rows(a, t, "tile_contract a")
    _check_rows(w, t, "tile_contract w")
    if a.dim() != 5 or w.dim() != 4 or a.shape[1] != w.shape[0]:
        raise ValueError(f"tile_contract: a {tuple(a.shape)} and w "
                         f"{tuple(w.shape)} do not fit")
    if not _kernels.on_cuda(a, w, t.q):
        return tile_contract_plain(a, w, t)
    X, I, C = a.shape[:3]
    Y = w.shape[1]
    if C > MAX_COMPS:
        raise ValueError(f"tile_contract: {C} components; the kernel takes "
                         f"at most {MAX_COMPS}")
    a, w = a.contiguous(), w.contiguous()
    _kernels.check_operand(a, "tile_contract a")
    _kernels.check_operand(w, "tile_contract w")
    out = torch.empty((X, Y, C, t.k, t.n), dtype=torch.int64, device=a.device)
    _kernels.launch("troy_tile_contract", out.get_device(), out, a, w, X, I, Y,
                    C, t.k, t.log_n, t.q, t.cr_lo, t.cr_hi)
    return out


def tile_pair_convolve_plain(a: torch.Tensor, w: torch.Tensor,
                             t: RnsNttTables) -> torch.Tensor:
    """The plain version of P2: a (X, s1, R, n), w (Yc, s2, R, n), words
    below 4q -> (X, Yc, s1 + s2 - 1, R, n), fully reduced."""
    s1, s2 = a.shape[1], w.shape[1]
    a = a.unsqueeze(1)                       # (X, 1, s1, R, n)
    w = w.unsqueeze(0)                       # (1, Yc, s2, R, n)
    outs = []
    for m in range(s1 + s2 - 1):
        pairs = [(a[:, :, i], w[:, :, m - i])
                 for i in range(max(0, m - s2 + 1), min(s1, m + 1))]
        outs.append(_reduced_sum(pairs, t, 2))
    return torch.stack(outs, dim=2)


def tile_pair_convolve(a: torch.Tensor, w: torch.Tensor,
                       t: RnsNttTables) -> torch.Tensor:
    """The ciphertext-degree convolution of every pair of an X x Yc grid
    (kernel P2, one launch): out[x, y, m] = sum_{i + i' = m} a[x, i] *
    w[y, i'] mod q_r per row r. a (X, s1, R, n) and w (Yc, s2, R, n) in the
    NTT domain, words below 4q, sizes at most 4; R rows over the moduli of
    t (q u Bsk for BFV, q for CKKS and BGV). Out (X, Yc, s1 + s2 - 1, R,
    n), fully reduced."""
    _check_pair(a, w, t, "tile_pair_convolve")
    if not _kernels.on_cuda(a, w, t.q):
        return tile_pair_convolve_plain(a, w, t)
    X, Y, s1, s2 = a.shape[0], w.shape[0], a.shape[1], w.shape[1]
    a, w = a.contiguous(), w.contiguous()
    _kernels.check_operand(a, "tile_pair_convolve a")
    _kernels.check_operand(w, "tile_pair_convolve w")
    out = torch.empty((X, Y, s1 + s2 - 1, t.k, t.n), dtype=torch.int64,
                      device=a.device)
    _kernels.launch("troy_tile_pair_convolve", out.get_device(), out, a, w, X,
                    Y, s1, s2, t.k, t.log_n, t.q, t.cr_lo, t.cr_hi)
    return out


def pack_group_fold_plain(data: torch.Tensor, pack_slots: int,
                          t: RnsNttTables) -> torch.Tensor:
    """The plain version of P3, in the JAX package's steps: zero-pad to
    whole groups, then P - 1 shifts and adds."""
    m = data.shape[0]
    groups = -(-m // pack_slots)
    pad = groups * pack_slots - m
    if pad:
        data = torch.cat([data, data.new_zeros((pad,) + data.shape[1:])])
    grouped = data.reshape((groups, pack_slots) + data.shape[1:])
    q = _col(t.q, data.dim() - 2, 1)
    acc = grouped[:, 0]
    for s in range(1, pack_slots):
        acc = u.add_mod(acc, negacyclic_shift_plain(grouped[:, s], s, t), q)
    return acc


def pack_group_fold(data: torch.Tensor, pack_slots: int,
                    t: RnsNttTables) -> torch.Tensor:
    """Fold each group of ``pack_slots`` ciphertexts into one (kernel P3,
    one launch): data (m, C, k, n), coefficient form, words below q ->
    (ceil(m / P), C, k, n), out[g] = sum_s x^s data[g P + s] mod x^n + 1,
    the members a ragged last group lacks taken as zero; fully reduced."""
    _check_rows(data, t, "pack_group_fold")
    if data.dim() != 4 or not 1 <= pack_slots <= t.n:
        raise ValueError(f"pack_group_fold: data {tuple(data.shape)}, "
                         f"pack_slots {pack_slots} (1 to n)")
    if not _kernels.on_cuda(data, t.q):
        return pack_group_fold_plain(data, pack_slots, t)
    m, C = data.shape[:2]
    data = data.contiguous()
    _kernels.check_operand(data, "pack_group_fold data")
    out = torch.empty((-(-m // pack_slots), C, t.k, t.n), dtype=torch.int64,
                      device=data.device)
    _kernels.launch("troy_pack_group_fold", out.get_device(), out, data, m,
                    pack_slots, C, t.k, t.log_n, t.q)
    return out
