"""The cross-shard modular sum (kernel R1, csrc/sharding.cu).

With the RNS-limb axis of a key switch split over ranks, each rank's
kernel-B inner product covers only its own decomposition digits; the ranks
all-gather these partials and ``shard_modsum`` adds them mod each limb's
prime, giving the words kernel B gives for the whole sum
(troy_tpu/parallel/sharding.py:153, where GSPMD inserts an all-reduce).
The wrapper launches the kernel for tensors on CUDA and runs
``shard_modsum_plain`` for tensors on the CPU.
"""

from __future__ import annotations

import torch

from . import u64ops as u
from .. import _kernels
from .ntt import RnsNttTables, _col


def shard_modsum_plain(parts: torch.Tensor, t: RnsNttTables) -> torch.Tensor:
    """The plain version of R1: parts (w, ..., k, n), words below q per
    limb -> (..., k, n), their sum mod q, fully reduced."""
    q = _col(t.q, parts.dim() - 3, 1)
    acc = parts[0]
    for r in range(1, parts.shape[0]):
        acc = u.add_mod(acc, parts[r], q)
    return acc


def shard_modsum(parts: torch.Tensor, t: RnsNttTables) -> torch.Tensor:
    """sum_r parts[r] mod q per limb (kernel R1, one launch): parts
    (w, ..., k, n) with rows (..., k, n) over the base t (any row length:
    a coefficient shard's too), every word below its limb's prime; out
    (..., k, n), fully reduced."""
    if parts.dim() < 3 or parts.shape[0] < 1 or parts.shape[-2] != t.k:
        raise ValueError(f"shard_modsum: expected (w, ..., {t.k}, n), got "
                         f"{tuple(parts.shape)}")
    if parts.dtype != torch.int64:
        raise TypeError(f"shard_modsum: expected int64 u64 words, got "
                        f"{parts.dtype}")
    if not _kernels.on_cuda(parts, t.q):
        return shard_modsum_plain(parts, t)
    n = parts.shape[-1]
    if n & (n - 1):
        raise ValueError(f"shard_modsum: rows of {n} words, not a power of "
                         "two")
    parts = parts.contiguous()
    _kernels.check_operand(parts, "shard_modsum parts")
    out = torch.empty(parts.shape[1:], dtype=torch.int64, device=parts.device)
    if out.numel():
        _kernels.launch("troy_shard_modsum", out.get_device(), out, parts,
                        parts.shape[0], out.numel(), n.bit_length() - 1, t.k,
                        t.q)
    return out
