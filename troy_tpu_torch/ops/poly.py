"""Elementwise RNS polynomial arithmetic, the BFV plain embedding and the
plain lift.

The port of troy_tpu/ops/poly.py. Arrays are (..., k, n) int64 tensors of
u64 words, limb-major, with per-limb moduli from the base's RnsNttTables.
``rns_add``, ``rns_sub``, ``rns_neg`` and ``rns_scalar_mul`` run on kernel
D (csrc/rns_elementwise.cu), ``bfv_plain_embed`` on kernel G and
``plain_lift`` on kernel G' (both csrc/plain_embed.cu) for tensors on
CUDA, and on their plain versions for tensors on the CPU (for G,
``bfv_multiply_add_plain``, the JAX package's function).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import u64ops as u
from .. import _kernels
from ..interop import to_torch
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
                 wq: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel D; into ``out`` (a contiguous tensor of a's shape that
    overlaps no input) if given, else into a new tensor."""
    _check_rows(a, t, "rns_elementwise")
    if b is not None and b.shape != a.shape:
        raise ValueError(f"rns_elementwise: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if out is not None and out.shape != a.shape:
        raise ValueError(f"rns_elementwise: out {tuple(out.shape)} is not "
                         f"{tuple(a.shape)}")
    operands = [x for x in (a, b, t.q, w, wq, out) if x is not None]
    if not _kernels.on_cuda(*operands):
        res = rns_elementwise_plain(op, a, b, t, w, wq)
        return res if out is None else out.copy_(res)
    a = a.contiguous()
    _kernels.check_operand(a, "rns_elementwise a")
    if b is not None:
        b = b.contiguous()
        _kernels.check_operand(b, "rns_elementwise b")
    if out is None:
        out = torch.empty_like(a)
    _kernels.check_operand(out, "rns_elementwise out")
    _kernels.launch("troy_rns_elementwise", out, a, b, op, a.numel() // t.n,
                    t.log_n, t.k, t.q, w, wq)
    return out


def rns_add(a: torch.Tensor, b: torch.Tensor, t: RnsNttTables,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(a + b) mod q_i per limb, inputs in [0, q_i); into ``out`` if given
    (contiguous, overlapping neither input)."""
    return _elementwise(ADD, a, b, t, out=out)


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
    """BFV plain embedding c0 +/- round(Q/t * m) per limb, the plain
    version of kernel G (scalingvariant.cpp
    multiplyAddPlainWithScalingVariant).

    round(Q*m/t) = m*floor(Q/t) + fix, fix = floor((m*(Q mod t) + (t+1)/2)/t).
    The 128/64 exact division subtracts the Barrett remainder, shifts out
    the power-of-two part of t, then multiplies by the inverse of the odd
    part mod 2^64: the quotient is below 2^64, so the wrapping int64
    product is exact. m: (..., n) mod t; c0: (..., k, n)."""
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


def _plain_embed_consts(plain_modulus: int, q_mod_t: int,
                        coeff_div_plain: Tuple[int, ...],
                        t: RnsNttTables) -> torch.Tensor:
    """Kernel G's constants (csrc/plain_embed.cu), once per tables and
    scalars."""
    key = ("plain_embed", plain_modulus, q_mod_t, tuple(coeff_div_plain))
    if key not in t._memo:
        tt = plain_modulus
        ratio = (1 << 128) // tt
        s = (tt & -tt).bit_length() - 1
        d = [c % q for c, q in zip(coeff_div_plain, t.values)]
        words = ([tt, (tt + 1) >> 1, ratio & u.M64, ratio >> 64, s,
                  pow(tt >> s, -1, 1 << 64), q_mod_t] + list(t.values)
                 + [((1 << 128) // q) >> 64 for q in t.values] + d
                 + [u.shoup_quotient(w, q) for w, q in zip(d, t.values)])
        t._memo[key] = to_torch(np.array(words, dtype=np.uint64), t.device)
    return t._memo[key]


def bfv_plain_embed(m: torch.Tensor, c0: torch.Tensor, plain_modulus: int,
                    q_mod_t: int, coeff_div_plain: Tuple[int, ...],
                    t: RnsNttTables, subtract: bool = False) -> torch.Tensor:
    """BFV plain embedding c0 +/- round(Q/t * m) per limb (kernel G).
    m: (..., n) mod t; c0: (..., k, n) with the same leading axes."""
    _check_rows(c0, t, "bfv_plain_embed")
    if m.shape != c0.shape[:-2] + c0.shape[-1:]:
        raise ValueError(f"bfv_plain_embed: m {tuple(m.shape)} does not "
                         f"match c0 {tuple(c0.shape)}")
    consts = _plain_embed_consts(plain_modulus, q_mod_t, coeff_div_plain, t)
    if not _kernels.on_cuda(m, c0, consts):
        return bfv_multiply_add_plain(m, c0, plain_modulus, q_mod_t,
                                      coeff_div_plain, t, subtract)
    m, c0 = m.contiguous(), c0.contiguous()
    _kernels.check_operand(m, "bfv_plain_embed m")
    _kernels.check_operand(c0, "bfv_plain_embed c0")
    out = torch.empty_like(c0)
    _kernels.launch("troy_bfv_plain_embed", out, m, c0, m.numel() // t.n,
                    t.k, t.log_n, int(subtract), consts)
    return out


# --------------------------------------------------------------------------
# kernel G': the plain lift mod t -> RNS
# --------------------------------------------------------------------------

def plain_lift_consts(t: RnsNttTables, plain_modulus: int,
                      total_q: int) -> torch.Tensor:
    """Kernel G''s constants (csrc/plain_embed.cu): tt, then q (k), the
    high Barrett words (k) and (Q - tt) mod q (k). Made once per tables and
    plain modulus."""
    key = ("plain_lift", plain_modulus, total_q)
    if key not in t._memo:
        tt = plain_modulus
        words = ([tt] + list(t.values)
                 + [((1 << 128) // q) >> 64 for q in t.values]
                 + [(total_q - tt) % q for q in t.values])
        t._memo[key] = to_torch(np.array(words, dtype=np.uint64), t.device)
    return t._memo[key]


def plain_lift_plain(m: torch.Tensor, t: RnsNttTables, plain_modulus: int,
                     plain_upper_half_threshold: int, total_q: int,
                     correction_factor: int = 1) -> torch.Tensor:
    """The plain version of kernel G' (troy_tpu/ops/poly.py:71 plain_lift,
    after the BGV add_plain's m * cf mod t, troy_tpu/evaluator.py:767-768):
    m (..., n) mod t -> (..., k, n); coefficients at or above the threshold
    map to (m - t) mod q_i = (m mod q_i + (Q - t) mod q_i) mod q_i."""
    tt = plain_modulus
    if correction_factor % tt != 1:
        cf = correction_factor % tt
        m = u.mul_mod_shoup(m, cf, u.shoup_quotient(cf, tt), tt)
    outs = []
    for q in t.values:
        mi = m if tt <= q else u.barrett_reduce_64(m, q,
                                                   ((1 << 128) // q) >> 64)
        lifted = u.add_mod(mi, (total_q - tt) % q, q)
        outs.append(torch.where(m >= plain_upper_half_threshold, lifted, mi))
    return torch.stack(outs, dim=-2)


def plain_lift(m: torch.Tensor, t: RnsNttTables, plain_modulus: int,
               plain_upper_half_threshold: int, total_q: int,
               correction_factor: int = 1) -> torch.Tensor:
    """Lift a mod-t plaintext (..., n) to RNS residues (..., k, n) below q_i,
    centred: coefficients at or above the threshold ((t+1)/2 for the plain
    ops; t, which no coefficient reaches, for the BGV encrypt's raw
    residues) stand for m - t. With a correction factor cf the lift is of
    m * cf mod t (BGV add_plain). One kernel-G' launch."""
    if m.shape[-1] != t.n:
        raise ValueError(f"plain_lift: expected (..., {t.n}), got "
                         f"{tuple(m.shape)}")
    consts = plain_lift_consts(t, plain_modulus, total_q)
    if not _kernels.on_cuda(m, consts):
        return plain_lift_plain(m, t, plain_modulus,
                                plain_upper_half_threshold, total_q,
                                correction_factor)
    if t.k > 64:
        raise ValueError(f"plain_lift: {t.k} limbs; the kernel takes at "
                         "most 64")
    tt = plain_modulus
    cf = correction_factor % tt
    m = m.contiguous()
    _kernels.check_operand(m, "plain_lift m")
    out = torch.empty(m.shape[:-1] + (t.k, t.n), dtype=torch.int64,
                      device=m.device)
    _kernels.launch("troy_plain_lift", out, m, m.numel() // t.n, t.k,
                    t.log_n, plain_upper_half_threshold, cf,
                    u.shoup_quotient(cf, tt), consts)
    return out
