"""The Galois automorphism as a gather (kernel M, csrc/galois.cu).

The port of troy_tpu/evaluator.py ``_apply_permutation_signed`` (the
coefficient domain: out[j] = in[src[j]], negated mod q_i where the index
wrapped past x^n = -1, 0 staying 0) and ``_apply_permutation`` (the NTT
domain: a plain gather). Data is (..., k, n); one launch covers every row.
The index tables come from utils/galois.py and live on the device once per
(n, elt, device).
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
