"""The Galois automorphism as a gather (kernel M, csrc/galois.cu).

The port of troy_tpu/evaluator.py ``_apply_permutation_signed`` (the
coefficient domain: out[j] = in[src[j]], negated mod q_i where the index
wrapped past x^n = -1, 0 staying 0) and ``_apply_permutation`` (the NTT
domain: a plain gather). Data is (..., k, n); one launch covers every row.

Kernel M reads a packed table, one int32 word per output: the source index
in bits 0-30 and the negate flag in bit 31 (``pack_table``). The tables of
an element live on the device once per (n, elt, device): ``coeff_table``,
``ntt_table`` and ``ntt_inverse_table``, beside the index tables of
utils/galois.py that they pack (``coeff_permutation``,
``ntt_permutation``). ``permute`` is the kernel's wrapper;
``apply_permutation`` and ``apply_permutation_signed`` take the index
tables, packed once and kept on the index tensor while it is unchanged
(``packed``).

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

NEGATE = -(1 << 31)          # bit 31 of a table word, as an int32
INDEX_MASK = (1 << 31) - 1


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


def pack_table(src: torch.Tensor, keep: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Kernel M's table of index tables (..., n): int32 words, the source
    index in bits 0-30, bit 31 set where ``keep`` is False (the word is
    negated mod q_i); no bit 31 without ``keep``."""
    table = src.to(torch.int32)
    if keep is None:
        return table
    return table | torch.where(keep, 0, NEGATE).to(torch.int32)


def packed(src: torch.Tensor, keep: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """``pack_table(src, keep)``, kept on ``src`` and made again only after
    src or keep changes in place (their version counters) or keep is
    another tensor: the index tables' callers pay no launch to pack them
    after the first call. Inference tensors keep no version: packed each
    call."""
    if src.is_inference() or (keep is not None and keep.is_inference()):
        return pack_table(src, keep)
    key = (src._version, keep, None if keep is None else keep._version)
    hit = getattr(src, "_troy_packed", None)
    if hit is not None and hit[0][0] == key[0] and hit[0][1] is keep \
            and hit[0][2] == key[2]:
        return hit[1]
    table = pack_table(src, keep)
    src._troy_packed = (key, table)
    return table


def unpack_table(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src int64, keep bool) of a packed table."""
    return (table & INDEX_MASK).to(torch.int64), table >= 0


@lru_cache(maxsize=None)
def coeff_table(n: int, elt: int, device) -> torch.Tensor:
    """The packed coefficient-domain table of ``elt`` on ``device``."""
    return pack_table(*coeff_permutation(n, elt, device))


@lru_cache(maxsize=None)
def ntt_table(n: int, elt: int, device) -> torch.Tensor:
    """The packed NTT-domain table of ``elt`` on ``device``."""
    return pack_table(ntt_permutation(n, elt, device))


@lru_cache(maxsize=None)
def ntt_inverse_table(n: int, elt: int, device) -> torch.Tensor:
    """The packed inverse of the NTT-domain permutation of ``elt`` on
    ``device``: gathering by it undoes the automorphism's gather."""
    perm = galois_util.ntt_permutation(n, elt)
    inv = np.empty(n, dtype=np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
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


def _check_table(table: torch.Tensor, shape: tuple, name: str) -> None:
    """The kernel reads a table as dense int32 words of ``shape``."""
    if table.dtype != torch.int32 or table.shape != shape:
        raise ValueError(f"{name}: expected an int32 table of {shape}, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous table")


def permute(x: torch.Tensor, table: torch.Tensor,
            t: Optional[RnsNttTables] = None) -> torch.Tensor:
    """Kernel M: out[..., j] = x[..., table[j] & INDEX_MASK], negated mod
    q_i (the limbs of t, x (..., k, n)) where bit 31 of table[j] is set;
    without t a plain gather that ignores bit 31. table: (n,) int32, a
    packed table (``pack_table``)."""
    n = x.shape[-1]
    _check_table(table, (n,), "galois permutation")
    if t is not None and (x.dim() < 2 or x.shape[-2] != t.k):
        raise ValueError(f"galois permutation: expected (..., {t.k}, {n}), "
                         f"got {tuple(x.shape)}")
    operands = (x, table) if t is None else (x, table, t.q)
    if not _kernels.on_cuda(*operands):
        src, keep = unpack_table(table)
        if t is None:
            return apply_permutation_plain(x, src)
        return apply_permutation_signed_plain(x, src, keep, t)
    if n & (n - 1) or n < 4 or table.data_ptr() % 16:
        raise ValueError(f"galois permutation: n = {n} is not a power of two "
                         "of at least 4, or the table is not 16-byte aligned")
    if x.dtype != torch.int64:
        raise TypeError(f"galois permutation: expected int64 u64 words, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    _kernels.launch("troy_galois_permute", x.get_device(), out, x, table,
                    x.numel() // n, 1 if t is None else t.k,
                    n.bit_length() - 1, None if t is None else t.q)
    return out


def apply_permutation_signed(x: torch.Tensor, src: torch.Tensor,
                             keep: torch.Tensor,
                             t: RnsNttTables) -> torch.Tensor:
    """Coefficient-domain automorphism of (..., k, n) with per-limb moduli
    from t (kernel M): gather by src, negate mod q_i where keep is False.
    ``permute`` takes the tables packed (``packed``)."""
    if x.dim() < 2 or x.shape[-2] != t.k or x.shape[-1] != t.n:
        raise ValueError(f"apply_permutation_signed: expected (..., {t.k}, "
                         f"{t.n}), got {tuple(x.shape)}")
    if src.dtype != torch.int64 or keep.dtype != torch.bool:
        raise TypeError("galois permutation: src must be int64, keep bool")
    return permute(x, packed(src, keep), t)


def apply_permutation(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """NTT-domain automorphism (kernel M, unsigned): out[..., j] =
    x[..., perm[j]]. ``permute`` takes the table packed (``packed``)."""
    if perm.dtype != torch.int64:
        raise TypeError("galois permutation: src must be int64")
    return permute(x, packed(perm))


@lru_cache(maxsize=256)
def batched_tables(n: int, elts: Tuple[int, ...], device, signed: bool
                   ) -> torch.Tensor:
    """The packed tables of the elements, (m, n) int32, one row each, on
    ``device`` once per (n, elts, device, form): the coefficient-domain
    tables if ``signed``, else the NTT-domain permutations."""
    one = coeff_table if signed else ntt_table
    return torch.stack([one(n, e, device) for e in elts])


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


def permute_batched(x: torch.Tensor, tables: torch.Tensor, t: RnsNttTables,
                    comps_first: bool = False) -> torch.Tensor:
    """Kernel M with one packed table per leading batch index: x (m, ...,
    k, n), tables (m, n) int32 (or (1, n), one table for all;
    ``batched_tables``), each word negated mod q_i where its table word
    has bit 31. comps_first: x (m, c, k, n) is written as (c, m, k, n)."""
    if x.dim() < 3 or x.shape[-2] != t.k or x.shape[-1] != t.n:
        raise ValueError(f"permute_batched: expected (m, ..., {t.k}, "
                         f"{t.n}), got {tuple(x.shape)}")
    m, n = x.shape[0], t.n
    if tables.dim() != 2 or tables.shape[0] not in (1, m):
        raise ValueError(f"permute_batched: tables {tuple(tables.shape)} for "
                         f"data {tuple(x.shape)}")
    _check_table(tables, (tables.shape[0], n), "permute_batched")
    if comps_first and x.dim() != 4:
        raise ValueError("permute_batched: comps_first takes (m, c, k, n)")
    if not _kernels.on_cuda(x, tables, t.q):
        srcs, keeps = unpack_table(tables.expand(m, n))
        return permute_batched_plain(x, srcs, keeps, t, comps_first)
    if tables.data_ptr() % 16:
        raise ValueError("permute_batched: the tables are not 16-byte "
                         "aligned")
    if x.dtype != torch.int64:
        raise TypeError(f"permute_batched: expected int64 u64 words, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        x = x.contiguous()
    rows = x.numel() // n
    out = torch.empty_like(x)
    if comps_first:
        out = out.view((x.shape[1], m) + x.shape[2:])
    _kernels.launch("troy_galois_permute_batched", x.get_device(), out, x,
                    tables, rows, t.k, n.bit_length() - 1, t.q,
                    rows // m if tables.shape[0] == m else 0,
                    x.shape[1] if comps_first else 0)
    return out
