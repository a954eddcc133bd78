"""The Galois automorphism as a gather (kernel M, csrc/galois.cu).

The port of troy_tpu/evaluator.py ``_apply_permutation_signed`` (the
coefficient domain: out[j] = in[src[j]], negated mod q_i where the index
wrapped past x^n = -1, 0 staying 0) and ``_apply_permutation`` (the NTT
domain: a plain gather). Data is (..., k, n); one launch covers every row.
The index tables come from utils/galois.py and live on the device once per
(n, elt, device).

``permute_batched`` takes one table per leading batch index, (m, n), for
data (m, ..., k, n), and can write component-major: the hoisted Galois
path's output permutation and the batched fold's gather
(troy_tpu/evaluator.py:442-535), one launch each.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from . import u64ops as u
from .. import _kernels
from ..utils import galois as galois_util
from .ntt import RnsNttTables


@lru_cache(maxsize=None)
def coeff_permutation(n: int, elt: int, device) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """(src int64, keep bool) of the coefficient-domain automorphism on
    ``device``."""
    src, keep = galois_util.coeff_permutation(n, elt)
    return (torch.from_numpy(src.astype(np.int64)).to(device),
            torch.from_numpy(keep.copy()).to(device))


@lru_cache(maxsize=None)
def ntt_permutation(n: int, elt: int, device) -> torch.Tensor:
    """The NTT-domain permutation (int64) on ``device``."""
    perm = galois_util.ntt_permutation(n, elt)
    return torch.from_numpy(perm.astype(np.int64)).to(device)


@lru_cache(maxsize=None)
def ntt_inverse_permutation(n: int, elt: int, device) -> torch.Tensor:
    """The inverse of the NTT-domain permutation of ``elt`` (int64) on
    ``device``: gathering by it undoes the automorphism's gather."""
    perm = galois_util.ntt_permutation(n, elt)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    return torch.from_numpy(inv).to(device)


def apply_permutation_signed_plain(x: torch.Tensor, src: torch.Tensor,
                                   keep: torch.Tensor,
                                   t: RnsNttTables) -> torch.Tensor:
    """The plain version of kernel M's signed gather."""
    gathered = x.index_select(-1, src)
    q = t.q.reshape((1,) * (x.dim() - 2) + (t.k, 1))
    return torch.where(keep, gathered, u.neg_mod(gathered, q))


def apply_permutation_plain(x: torch.Tensor, perm: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version of kernel M's unsigned gather."""
    return x.index_select(-1, perm)


def _permute(x: torch.Tensor, src: torch.Tensor, keep: Optional[torch.Tensor],
             t: Optional[RnsNttTables]) -> torch.Tensor:
    n = x.shape[-1]
    if src.shape != (n,) or (keep is not None and keep.shape != (n,)):
        raise ValueError(f"galois permutation: tables of {tuple(src.shape)} "
                         f"for data {tuple(x.shape)}")
    if src.dtype != torch.int64 or (keep is not None
                                    and keep.dtype != torch.bool):
        raise TypeError("galois permutation: src must be int64, keep bool")
    operands = [x, src] + ([keep, t.q] if keep is not None else [])
    if not _kernels.on_cuda(*operands):
        if keep is None:
            return apply_permutation_plain(x, src)
        return apply_permutation_signed_plain(x, src, keep, t)
    if n & (n - 1):
        raise ValueError(f"galois permutation: n = {n} is not a power of two")
    x = x.contiguous()
    _kernels.check_operand(x, "galois permutation input")
    out = torch.empty_like(x)
    k = t.k if t is not None else 1
    _kernels.launch("troy_galois_permute", out, x, src.contiguous(),
                    None if keep is None else keep.contiguous(),
                    x.numel() // n, k, n.bit_length() - 1,
                    None if keep is None else t.q)
    return out


def apply_permutation_signed(x: torch.Tensor, src: torch.Tensor,
                             keep: torch.Tensor,
                             t: RnsNttTables) -> torch.Tensor:
    """Coefficient-domain automorphism of (..., k, n) with per-limb moduli
    from t (kernel M): gather by src, negate mod q_i where keep is False."""
    if x.dim() < 2 or x.shape[-2] != t.k or x.shape[-1] != t.n:
        raise ValueError(f"apply_permutation_signed: expected (..., {t.k}, "
                         f"{t.n}), got {tuple(x.shape)}")
    return _permute(x, src, keep, t)


def apply_permutation(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """NTT-domain automorphism (kernel M, unsigned): out[..., j] =
    x[..., perm[j]]."""
    return _permute(x, perm, None, None)


@lru_cache(maxsize=256)
def batched_tables(n: int, elts: Tuple[int, ...], device, signed: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(srcs (m, n) int64, keeps (m, n) bool or None) of the elements, one
    row each, on ``device`` once per (n, elts, device, form): the
    coefficient-domain tables if ``signed``, else the NTT-domain
    permutations."""
    if signed:
        pairs = [coeff_permutation(n, e, device) for e in elts]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]))
    return torch.stack([ntt_permutation(n, e, device) for e in elts]), None


def permute_batched_plain(x: torch.Tensor, srcs: torch.Tensor,
                          keeps: Optional[torch.Tensor],
                          t: Optional[RnsNttTables],
                          comps_first: bool = False) -> torch.Tensor:
    """The plain version of kernel M's batched gather."""
    m, n = srcs.shape
    lead = (m,) + (1,) * (x.dim() - 2) + (n,)
    index = srcs.reshape(lead).expand(x.shape[:-1] + (n,))
    out = x.gather(-1, index)
    if keeps is not None:
        q = t.q.reshape((1,) * (x.dim() - 2) + (t.k, 1))
        out = torch.where(keeps.reshape(lead), out, u.neg_mod(out, q))
    return out.transpose(0, 1).contiguous() if comps_first else out


def permute_batched(x: torch.Tensor, srcs: torch.Tensor,
                    keeps: Optional[torch.Tensor], t: RnsNttTables,
                    comps_first: bool = False) -> torch.Tensor:
    """Kernel M with one table per leading batch index: x (m, ..., k, n),
    srcs (m, n) int64 (or (1, n), one table for all), keeps (m, n) bool for
    the signed coefficient-domain gather (moduli from t) or None for the
    NTT-domain one. comps_first: x (m, c, k, n) is written as (c, m, k,
    n)."""
    if x.dim() < 3 or x.shape[-2] != t.k or x.shape[-1] != t.n:
        raise ValueError(f"permute_batched: expected (m, ..., {t.k}, "
                         f"{t.n}), got {tuple(x.shape)}")
    m, n = x.shape[0], t.n
    if srcs.dim() != 2 or srcs.shape[1] != n or srcs.shape[0] not in (1, m) \
            or (keeps is not None and keeps.shape != srcs.shape):
        raise ValueError(f"permute_batched: tables {tuple(srcs.shape)} for "
                         f"data {tuple(x.shape)}")
    if srcs.dtype != torch.int64 or (keeps is not None
                                     and keeps.dtype != torch.bool):
        raise TypeError("permute_batched: src must be int64, keep bool")
    if comps_first and x.dim() != 4:
        raise ValueError("permute_batched: comps_first takes (m, c, k, n)")
    operands = [x, srcs, t.q] + ([keeps] if keeps is not None else [])
    if not _kernels.on_cuda(*operands):
        if srcs.shape[0] != m:
            srcs = srcs.expand(m, n)
            keeps = None if keeps is None else keeps.expand(m, n)
        return permute_batched_plain(x, srcs, keeps, t, comps_first)
    x = x.contiguous()
    _kernels.check_operand(x, "permute_batched input")
    rows = x.numel() // n
    shape = ((x.shape[1], m) + x.shape[2:]) if comps_first else x.shape
    out = torch.empty(shape, dtype=torch.int64, device=x.device)
    _kernels.launch("troy_galois_permute_batched", out, x,
                    srcs.contiguous(),
                    None if keeps is None else keeps.contiguous(), rows, t.k,
                    n.bit_length() - 1, t.q,
                    rows // m if srcs.shape[0] == m else 0,
                    x.shape[1] if comps_first else 0)
    return out
