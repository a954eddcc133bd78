"""Elementwise RNS polynomial arithmetic and the BFV plain embedding.

The port of troy_tpu/ops/poly.py (BFV subset). Arrays are (..., k, n)
int64 tensors of u64 words, limb-major, with per-limb moduli from the
base's RnsNttTables. ``rns_add``, ``rns_sub``, ``rns_neg`` and
``rns_scalar_mul`` run on kernel D (csrc/rns_elementwise.cu) for tensors
on CUDA and on their plain versions for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import u64ops as u
from .. import _kernels
from .ntt import RnsNttTables, _check_rows, _col

ADD, SUB, NEG, SCALAR_MUL = 0, 1, 2, 3


def rns_elementwise_plain(op: int, a: torch.Tensor, b: Optional[torch.Tensor],
                          t: RnsNttTables, w: Optional[torch.Tensor] = None,
                          wq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel D."""
    L = a.dim() - 2
    q = _col(t.q, L, 1)
    if op == ADD:
        return u.add_mod(a, b, q)
    if op == SUB:
        return u.sub_mod(a, b, q)
    if op == NEG:
        return u.neg_mod(a, q)
    return u.mul_mod_shoup(a, _col(w, L, 1), _col(wq, L, 1), q)


def _elementwise(op: int, a: torch.Tensor, b: Optional[torch.Tensor],
                 t: RnsNttTables, w: Optional[torch.Tensor] = None,
                 wq: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check_rows(a, t, "rns_elementwise")
    if b is not None and b.shape != a.shape:
        raise ValueError(f"rns_elementwise: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    operands = [x for x in (a, b, t.q, w, wq) if x is not None]
    if not _kernels.on_cuda(*operands):
        return rns_elementwise_plain(op, a, b, t, w, wq)
    a = a.contiguous()
    _kernels.check_operand(a, "rns_elementwise a")
    if b is not None:
        b = b.contiguous()
        _kernels.check_operand(b, "rns_elementwise b")
    out = torch.empty_like(a)
    _kernels.launch("troy_rns_elementwise", out, a, b, op, a.numel() // t.n,
                    t.log_n, t.k, t.q, w, wq)
    return out


def rns_add(a: torch.Tensor, b: torch.Tensor, t: RnsNttTables) -> torch.Tensor:
    """(a + b) mod q_i per limb, inputs in [0, q_i)."""
    return _elementwise(ADD, a, b, t)


def rns_sub(a: torch.Tensor, b: torch.Tensor, t: RnsNttTables) -> torch.Tensor:
    """(a - b) mod q_i per limb, inputs in [0, q_i)."""
    return _elementwise(SUB, a, b, t)


def rns_neg(a: torch.Tensor, t: RnsNttTables) -> torch.Tensor:
    """(-a) mod q_i per limb, input in [0, q_i)."""
    return _elementwise(NEG, a, None, t)


def rns_scalar_mul(x: torch.Tensor, scalars: Sequence[int],
                   t: RnsNttTables) -> torch.Tensor:
    """x * s_i mod q_i per limb (Shoup); x may be any u64 word. The
    per-limb constants are made once per scalar list on the tables."""
    w, wq = t.scalar_operand(scalars)
    return _elementwise(SCALAR_MUL, x, None, t, w, wq)


def rns_broadcast_scalar_mul(x: torch.Tensor, scalar: int,
                             t: RnsNttTables) -> torch.Tensor:
    """x * s mod q_i for one integer s (reduced per limb)."""
    return rns_scalar_mul(x, [scalar] * t.k, t)


def bfv_multiply_add_plain(m: torch.Tensor, c0: torch.Tensor,
                           plain_modulus: int, q_mod_t: int,
                           coeff_div_plain: Tuple[int, ...],
                           t: RnsNttTables, subtract: bool = False
                           ) -> torch.Tensor:
    """BFV plain embedding: c0 +/- round(Q/t * m) per limb
    (scalingvariant.cpp multiplyAddPlainWithScalingVariant).

    round(Q*m/t) = m*floor(Q/t) + fix, fix = floor((m*(Q mod t) + (t+1)/2)/t).
    The 128/64 exact division subtracts the Barrett remainder, shifts out
    the power-of-two part of t, then multiplies by the inverse of the odd
    part mod 2^64: the quotient is below 2^64, so the wrapping int64
    product is exact. m: (..., n) mod t; c0: (..., k, n). Plain torch."""
    tt = plain_modulus
    half = (tt + 1) >> 1
    ratio = (1 << 128) // tt
    lo, hi = u.mul128(m, q_mod_t)
    lo2 = lo + u.s64(half)
    hi2 = hi + u.ult(lo2, lo).to(torch.int64)
    r = u.barrett_reduce_128(lo2, hi2, tt, ratio & u.M64, ratio >> 64)
    s = (tt & -tt).bit_length() - 1
    odd = tt >> s
    lo3 = lo2 - r
    hi3 = hi2 - u.ult(lo2, r).to(torch.int64)
    if s:
        lo3 = u.shr(lo3, s) | (hi3 << (64 - s))
    fix = lo3 * u.s64(pow(odd, -1, 1 << 64))

    L = c0.dim() - 2
    q = _col(t.q, L, 1)
    d, d_shoup = t.scalar_operand(coeff_div_plain)
    scaled = u.mul_mod_shoup(m.unsqueeze(-2), _col(d, L, 1),
                             _col(d_shoup, L, 1), q)
    term = u.barrett_reduce_64(scaled + fix.unsqueeze(-2), q,
                               _col(t.cr_hi, L, 1))
    return u.sub_mod(c0, term, q) if subtract else u.add_mod(c0, term, q)
