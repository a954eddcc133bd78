"""Elementwise RNS polynomial arithmetic, the BFV plain embedding and the
plain lift.

The port of troy_tpu/ops/poly.py. Arrays are (..., k, n) int64 tensors of
u64 words, limb-major, with per-limb moduli from the base's RnsNttTables.
``rns_add``, ``rns_sub``, ``rns_neg`` and ``rns_scalar_mul`` run on kernel
D (csrc/rns_elementwise.cu), as do its fused forms ``zero_sym_finish``,
``zero_asym_finish``, ``switching_key_rows``, ``balanced_add`` and
``rns_add_c0`` (one launch each for a chain of those steps),
``zero_sym_embed`` and ``zero_asym_embed`` on DG (BFV's finishes with the
plain embedding, on D's grid) and ``bfv_plain_embed`` on kernel G (on D's
grid too, csrc/rns_elementwise.cu), ``plain_lift`` on kernel G'
(csrc/plain_embed.cu; ``plain_lift_ntt`` routes a lift and its transform
to AGp, G' folded into A's first pass, on A's route), the negacyclic
shift family ``negacyclic_shift``, ``extract_lwe_many`` and
``assemble_lwe`` on kernel N1 and the pack-tree prepare
``pack_fold_prepare`` on kernel N2 (both csrc/negacyclic.cu) for tensors
on CUDA, and on their plain versions for tensors on the CPU (for G,
``bfv_multiply_add_plain``, the JAX package's function).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import u64ops as u
from .. import _kernels
from ..interop import to_torch
from .ntt import (RnsNttTables, _check_rows, _col, on_a_route,
                  rns_ntt_forward, rns_ntt_forward_lift)

ADD, SUB, NEG, SCALAR_MUL = 0, 1, 2, 3
# kernel D's fused forms (csrc/rns_elementwise.cu)
ZERO_SYM, ZERO_ASYM, KEY_ROWS, BALANCED_ADD, BALANCED_SUB = 4, 5, 6, 7, 8


def rns_elementwise_plain(op: int, a: torch.Tensor, b: Optional[torch.Tensor],
                          t: RnsNttTables, w: Optional[torch.Tensor] = None,
                          wq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel D's add, sub, negate and scalar multiply."""
    L = a.dim() - 2
    q = _col(t.q, L, 1)
    if op == ADD:
        return u.add_mod(a, b, q)
    if op == SUB:
        return u.sub_mod(a, b, q)
    if op == NEG:
        return u.neg_mod(a, q)
    return u.mul_mod_shoup(a, _col(w, L, 1), _col(wq, L, 1), q)


def zero_sym_finish_plain(x: torch.Tensor, y: torch.Tensor, t: RnsNttTables,
                          m: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of D's zero-encryption finish: m - (x + y) mod q_i,
    the words of neg(add(x, y)) then + m (troy_tpu/rlwe.py:125-131,
    encryptor.py:29-49)."""
    q = _col(t.q, x.dim() - 2, 1)
    z = u.add_mod(x, y, q)
    return u.neg_mod(z, q) if m is None else u.sub_mod(m, z, q)


def zero_asym_finish_plain(x: torch.Tensor, y: torch.Tensor, t: RnsNttTables,
                           m: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of D's public-key finish: x + y mod q_i per component,
    + m on the first (troy_tpu/rlwe.py:327-330, encryptor.py:29-49)."""
    q = _col(t.q, x.dim() - 2, 1)
    out = u.add_mod(x, y, q)
    if m is not None:
        out[0] = u.add_mod(out[0], m, _col(t.q, m.dim() - 2, 1))
    return out


def key_rows_finish_plain(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                          special: int, t: RnsNttTables) -> torch.Tensor:
    """Plain version of D's switching-key rows: c0 of row j is -(x + y)
    with P w_j mod q_j added on limb j (troy_tpu/keygen.py:47-54); x, y
    (decomp, k, n), w (>= decomp, n)."""
    c0 = zero_sym_finish_plain(x, y, t)
    p, pq = t.scalar_operand([special] * t.k)
    for j in range(x.shape[0]):
        term = u.mul_mod_shoup(w[j], p[j], pq[j], t.q[j])
        c0[j, j] = u.add_mod(c0[j, j], term, t.q[j])
    return c0


def balanced_add_plain(x: torch.Tensor, y: torch.Tensor, e1: int, e2: int,
                       t: RnsNttTables, subtract: bool = False
                       ) -> torch.Tensor:
    """Plain version of D's balanced add: e1 x +- e2 y mod q_i
    (troy_tpu/evaluator.py:874-883)."""
    L = x.dim() - 2
    q = _col(t.q, L, 1)
    w1, w1q = t.scalar_operand([e1] * t.k)
    w2, w2q = t.scalar_operand([e2] * t.k)
    a = u.mul_mod_shoup(x, _col(w1, L, 1), _col(w1q, L, 1), q)
    b = u.mul_mod_shoup(y, _col(w2, L, 1), _col(w2q, L, 1), q)
    return u.sub_mod(a, b, q) if subtract else u.add_mod(a, b, q)


def _groups(x: torch.Tensor, t: RnsNttTables, name: str) -> int:
    _check_rows(x, t, name)
    return x.numel() // (t.k * t.n)


def _group_stride(out: torch.Tensor, t: RnsNttTables, name: str) -> int:
    """The word stride between out's (k, n) groups, which must be uniform
    (a 2-D out is one group; a 3-D out any group stride)."""
    if out.dim() not in (2, 3) or out.stride(-1) != 1 or \
            out.stride(-2) != t.n:
        raise ValueError(f"{name}: out {tuple(out.shape)} with strides "
                         f"{out.stride()} is not (k, n) rows in groups")
    return out.stride(0) if out.dim() == 3 else t.k * t.n


def _c1_view(out: torch.Tensor, t: RnsNttTables,
             component: int = 1) -> torch.Tensor:
    """The component ``component`` places after each of out's groups (c1
    after c0)."""
    return torch.as_strided(out, out.shape, out.stride(),
                            out.storage_offset() + component * t.k * t.n)


_NO_CONSTS = (None, None)


def _aligned(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Kernel D moves 16 bytes a load and a store: every operand's address
    a multiple of 16 (a row start of an even n is)."""
    ptr = 0
    for v in tensors:
        if v is not None:
            ptr |= v.data_ptr()
    if ptr & 15:
        raise ValueError(f"{name}: an operand is not 16-byte aligned")


def _launch_d(op: int, out: torch.Tensor, out_stride: int, x: torch.Tensor,
              y: Optional[torch.Tensor], groups: int, t: RnsNttTables,
              m: Optional[torch.Tensor] = None, m_stride: int = 0,
              m_groups: int = 0, c1: Optional[torch.Tensor] = None,
              w1=_NO_CONSTS, w2=_NO_CONSTS) -> None:
    """One kernel-D launch over ``groups`` (k, n) groups
    (csrc/rns_elementwise.cu): x, y, m and c1 contiguous, out's groups at
    ``out_stride`` words; the caller has checked the operands."""
    if t.n % 2:
        raise ValueError("rns_elementwise: n is odd")
    _kernels.launch("troy_rns_elementwise", out.get_device(), out, out_stride,
                    x, y, m, m_stride, m_groups, c1, op, groups, t.k, t.log_n,
                    t.q, w1[0], w1[1], w2[0], w2[1])


def _check_fused(name: str, out: torch.Tensor, t: RnsNttTables,
                 *operands: Optional[torch.Tensor],
                 c1: Optional[torch.Tensor] = None, copies: int = 1) -> int:
    """A fused form's operands checked (contiguous int64 CUDA tensors,
    aligned; out int64 on CUDA, its (k, n) groups at one even stride, with
    room for c1's ``copies`` components after each); returns out's group
    stride."""
    for v in operands + (c1,):
        if v is not None:
            _kernels.check_operand(v, f"{name} operand")
    if out.dtype != torch.int64 or not out.is_cuda:
        raise TypeError(f"{name} out: expected int64 words on CUDA")
    stride = _group_stride(out, t, name)
    kn = t.k * t.n
    if stride % 2:
        raise ValueError(f"{name}: out's group stride {stride} is odd")
    if c1 is not None:
        groups = c1.numel() // (kn * copies)
        span = (1 + copies) * kn
        end = out.storage_offset() + (groups - 1) * stride + span
        if (groups > 1 and stride < span) or \
                end * 8 > out.untyped_storage().nbytes():
            raise ValueError(f"{name}: no room for c1 after out's groups")
    _aligned(name, out, c1, *operands)
    return stride


def _elementwise(op: int, a: torch.Tensor, b: Optional[torch.Tensor],
                 t: RnsNttTables, w: Optional[torch.Tensor] = None,
                 wq: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel D's add, sub, negate or scalar multiply; into ``out`` (a
    contiguous tensor of a's shape that overlaps no input) if given, else
    into a new tensor."""
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
    _aligned("rns_elementwise", a, b, out)
    kn = t.k * t.n
    _launch_d(op, out, kn, a, b, a.numel() // kn, t, w1=(w, wq))
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


def zero_sym_finish(x: torch.Tensor, y: torch.Tensor, t: RnsNttTables,
                    m: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None,
                    c1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The symmetric zero encryption's finish, with the plaintext's add:
    c0 = m - (x + y) mod q_i (m = 0 if None), x = a s and y = e (NTT
    form, or both in coefficient form), one kernel-D launch. x, y, m:
    (k, n) or (G, k, n) of reduced words. ``out``: c0's destination of x's
    shape, a new tensor if None, else any view whose (k, n) groups lie at
    one stride, such as c0 of a (G, 2, k, n) ciphertext batch, and it may
    be x itself; ``c1`` (x's shape) is then copied into the component after
    each c0 (the ciphertext's c1) in the same launch. Returns out."""
    G = _groups(x, t, "zero_sym_finish")
    if y.shape != x.shape or (m is not None and m.shape != x.shape) or (
            c1 is not None and c1.shape != x.shape):
        raise ValueError("zero_sym_finish: operands differ in shape")
    if out is None:
        if c1 is not None:
            raise ValueError("zero_sym_finish: c1 needs out in a ciphertext")
        out = torch.empty_like(x)
    if out.shape != x.shape:
        raise ValueError(f"zero_sym_finish: out {tuple(out.shape)}")
    operands = [v for v in (x, y, m, c1, out, t.q) if v is not None]
    if not _kernels.on_cuda(*operands):
        out.copy_(zero_sym_finish_plain(x, y, t, m))
        if c1 is not None:
            _c1_view(out, t).copy_(c1)
        return out
    x, y = x.contiguous(), y.contiguous()
    m = None if m is None else m.contiguous()
    c1 = None if c1 is None else c1.contiguous()
    stride = _check_fused("zero_sym_finish", out, t, x, y, m, c1=c1)
    _launch_d(ZERO_SYM, out, stride, x, y, G, t, m, t.k * t.n, G, c1)
    return out


def zero_asym_finish(x: torch.Tensor, y: torch.Tensor, t: RnsNttTables,
                     m: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The public-key zero encryption's finish, with the plaintext's add:
    c_j = x_j + y_j mod q_i (x = pk_j u, y = e_j), + m on c_0; one kernel-D
    launch. x, y, out: (size, k, n) (out may be x); m: (k, n) or None."""
    G = _groups(x, t, "zero_asym_finish")
    if y.shape != x.shape or x.dim() != 3 or (
            m is not None and m.shape != x.shape[1:]):
        raise ValueError("zero_asym_finish: operands do not fit")
    if out is None:
        out = torch.empty_like(x)
    if out.shape != x.shape:
        raise ValueError(f"zero_asym_finish: out {tuple(out.shape)}")
    operands = [v for v in (x, y, m, out, t.q) if v is not None]
    if not _kernels.on_cuda(*operands):
        return out.copy_(zero_asym_finish_plain(x, y, t, m))
    x, y = x.contiguous(), y.contiguous()
    m = None if m is None else m.contiguous()
    stride = _check_fused("zero_asym_finish", out, t, x, y, m)
    _launch_d(ZERO_ASYM, out, stride, x, y, G, t, m, 0, 1)
    return out


def switching_key_rows(x: torch.Tensor, y: torch.Tensor, a: torch.Tensor,
                       w: torch.Tensor, special: int,
                       t: RnsNttTables) -> torch.Tensor:
    """The dense switching key (decomp, 2, k, n) from decomp NTT-form zero
    encryptions' a s (x), e (y) and a (each (decomp, k, n)) and the target
    w (>= decomp, n), row j over q_j: c0 of row j is P w_j - (x_j + y_j)
    on limb j and -(x_j + y_j) on the others, c1 is a_j; one kernel-D
    launch writes the whole key."""
    G = _groups(x, t, "switching_key_rows")
    if x.dim() != 3 or y.shape != x.shape or a.shape != x.shape or \
            w.dim() != 2 or w.shape[0] < G or w.shape[1] != t.n:
        raise ValueError("switching_key_rows: operands do not fit")
    key = torch.empty((G, 2, t.k, t.n), dtype=torch.int64, device=x.device)
    if not _kernels.on_cuda(x, y, a, w, t.q):
        key[:, 0] = key_rows_finish_plain(x, y, w, special, t)
        key[:, 1] = a
        return key
    x, y, a, w = x.contiguous(), y.contiguous(), a.contiguous(), \
        w.contiguous()
    stride = _check_fused("switching_key_rows", key[:, 0], t, x, y, w, c1=a)
    _launch_d(KEY_ROWS, key[:, 0], stride, x, y, G, t, w, t.n, G, a,
              w1=t.scalar_operand([special] * t.k))
    return key


def balanced_add(x: torch.Tensor, y: torch.Tensor, e1: int, e2: int,
                 t: RnsNttTables, subtract: bool = False) -> torch.Tensor:
    """e1 x +- e2 y mod q_i per limb (BGV's add and sub of two correction
    factors, brought to one); any words x, y of one shape; one kernel-D
    launch."""
    _check_rows(x, t, "balanced_add")
    if y.shape != x.shape:
        raise ValueError(f"balanced_add: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} differ")
    if not _kernels.on_cuda(x, y, t.q):
        return balanced_add_plain(x, y, e1, e2, t, subtract)
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    for v in (x, y):
        _kernels.check_operand(v, "balanced_add operand")
    _aligned("balanced_add", x, y)
    kn = t.k * t.n
    _launch_d(BALANCED_SUB if subtract else BALANCED_ADD, out, kn, x, y,
              x.numel() // kn, t, w1=t.scalar_operand([e1] * t.k),
              w2=t.scalar_operand([e2] * t.k))
    return out


def rns_add_c0(data: torch.Tensor, m: torch.Tensor, t: RnsNttTables,
               subtract: bool = False) -> torch.Tensor:
    """A new ciphertext: data (size, k, n) with the words m (k, n) added to
    (subtracted from) its c0 mod q_i and its other components copied; one
    kernel-D launch writes c0 and copies c1 (a copy for any component after
    c1): the NTT-form add_plain of CKKS and BGV."""
    _check_rows(data, t, "rns_add_c0")
    if data.dim() != 3 or m.shape != data.shape[1:]:
        raise ValueError(f"rns_add_c0: data {tuple(data.shape)} and m "
                         f"{tuple(m.shape)} do not fit")
    out = torch.empty_like(data)
    if not _kernels.on_cuda(data, m, t.q):
        out[0] = rns_elementwise_plain(SUB if subtract else ADD, data[0], m,
                                       t)
        out[1:] = data[1:]
        return out
    data, m = data.contiguous(), m.contiguous()
    c1 = data[1] if data.shape[0] > 1 else None
    _check_fused("rns_add_c0", out[0], t, data, m, c1=c1)
    _launch_d(SUB if subtract else ADD, out[0], t.k * t.n, data[0], m, 1, t,
              c1=c1)
    if data.shape[0] > 2:
        out[2:] = data[2:]
    return out


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


def zero_sym_embed_plain(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
                         plain_modulus: int, q_mod_t: int,
                         coeff_div_plain: Tuple[int, ...],
                         t: RnsNttTables) -> torch.Tensor:
    """The plain version of DG's symmetric finish: D's finish -(x + y),
    then G's c0 + round(Q m / t) (troy_tpu/rlwe.py:125-131, then
    troy_tpu/ops/poly.py:98 as troy_tpu/encryptor.py:29 adds it). x, y:
    (..., k, n); m: (..., n) mod t."""
    return bfv_multiply_add_plain(m, zero_sym_finish_plain(x, y, t),
                                  plain_modulus, q_mod_t, coeff_div_plain, t)


def zero_asym_embed_plain(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
                          plain_modulus: int, q_mod_t: int,
                          coeff_div_plain: Tuple[int, ...],
                          t: RnsNttTables) -> torch.Tensor:
    """The plain version of DG's public-key finish: D's x + y per
    component, then G's round(Q m / t) onto the first (troy_tpu/rlwe.py:
    327-330, then troy_tpu/ops/poly.py:98). x, y: (size, k, n); m: (n,)."""
    out = zero_asym_finish_plain(x, y, t)
    out[0] = bfv_multiply_add_plain(m, out[0], plain_modulus, q_mod_t,
                                    coeff_div_plain, t)
    return out


def _plain_embed_consts(plain_modulus: int, q_mod_t: int,
                        coeff_div_plain: Tuple[int, ...],
                        t: RnsNttTables) -> torch.Tensor:
    """G's and DG's constants (csrc/plain_embed.cuh EmbedLayout): t,
    (t+1)/2, Q mod t and its Shoup word mod t, then per limb q, the high
    Barrett word, floor(Q/t) mod q and its Shoup word; once per tables and
    scalars."""
    key = ("plain_embed", plain_modulus, q_mod_t, tuple(coeff_div_plain))
    if key not in t._memo:
        tt = plain_modulus
        d = [c % q for c, q in zip(coeff_div_plain, t.values)]
        words = ([tt, (tt + 1) >> 1, q_mod_t % tt,
                  u.shoup_quotient(q_mod_t % tt, tt)] + list(t.values)
                 + [((1 << 128) // q) >> 64 for q in t.values] + d
                 + [u.shoup_quotient(w, q) for w, q in zip(d, t.values)])
        t._memo[key] = to_torch(np.array(words, dtype=np.uint64), t.device)
    return t._memo[key]


def _check_embed_m(name: str, m: torch.Tensor, shape: tuple) -> None:
    if m.dtype != torch.int64 or tuple(m.shape) != shape:
        raise ValueError(f"{name}: m {tuple(m.shape)} {m.dtype}, expected "
                         f"{shape} int64 words")


def zero_sym_embed(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
                   plain_modulus: int, q_mod_t: int,
                   coeff_div_plain: Tuple[int, ...], t: RnsNttTables,
                   out: Optional[torch.Tensor] = None,
                   c1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BFV's symmetric zero-encryption finish with its plaintext (DG, one
    launch on D's grid): c0 = round(Q m / t) - (x + y) mod q_i, the words of
    D's finish -(x + y) then G's add. x = a s, y = e in coefficient form,
    (k, n) or (G, k, n); m (n,) or (G, n) mod t. ``out`` and ``c1`` as for
    ``zero_sym_finish`` (out may be x; c1 copied into the component after
    each c0). Returns out."""
    G = _groups(x, t, "zero_sym_embed")
    if y.shape != x.shape or (c1 is not None and c1.shape != x.shape):
        raise ValueError("zero_sym_embed: operands differ in shape")
    _check_embed_m("zero_sym_embed", m, tuple(x.shape[:-2]) + (t.n,))
    if out is None:
        if c1 is not None:
            raise ValueError("zero_sym_embed: c1 needs out in a ciphertext")
        out = torch.empty_like(x)
    if out.shape != x.shape:
        raise ValueError(f"zero_sym_embed: out {tuple(out.shape)}")
    args = (plain_modulus, q_mod_t, coeff_div_plain)
    consts = _plain_embed_consts(*args, t)
    operands = [v for v in (x, y, m, c1, out, consts) if v is not None]
    if not _kernels.on_cuda(*operands):
        out.copy_(zero_sym_embed_plain(x, y, m, *args, t))
        if c1 is not None:
            _c1_view(out, t).copy_(c1)
        return out
    x, y, m = x.contiguous(), y.contiguous(), m.contiguous()
    c1 = None if c1 is None else c1.contiguous()
    stride = _check_fused("zero_sym_embed", out, t, x, y, m, c1=c1)
    _kernels.launch("troy_rns_zero_embed", out.get_device(), out, stride, x,
                    y, m, t.n, c1, 0, G, t.k, t.log_n, consts)
    return out


def zero_asym_embed(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
                    plain_modulus: int, q_mod_t: int,
                    coeff_div_plain: Tuple[int, ...], t: RnsNttTables,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BFV's public-key zero-encryption finish with its plaintext (DG, one
    launch on D's grid): c_j = x_j + y_j mod q_i (x = pk_j u, y = e_j, in
    coefficient form), + round(Q m / t) on c_0. x, y, out: (size, k, n)
    (out may be x); m: (n,) mod t."""
    G = _groups(x, t, "zero_asym_embed")
    if y.shape != x.shape or x.dim() != 3:
        raise ValueError("zero_asym_embed: operands do not fit")
    _check_embed_m("zero_asym_embed", m, (t.n,))
    if out is None:
        out = torch.empty_like(x)
    if out.shape != x.shape:
        raise ValueError(f"zero_asym_embed: out {tuple(out.shape)}")
    args = (plain_modulus, q_mod_t, coeff_div_plain)
    consts = _plain_embed_consts(*args, t)
    if not _kernels.on_cuda(x, y, m, out, consts):
        return out.copy_(zero_asym_embed_plain(x, y, m, *args, t))
    x, y, m = x.contiguous(), y.contiguous(), m.contiguous()
    stride = _check_fused("zero_asym_embed", out, t, x, y, m)
    _kernels.launch("troy_rns_zero_embed", out.get_device(), out, stride, x,
                    y, m, 0, None, 1, G, t.k, t.log_n, consts)
    return out


def bfv_plain_embed(m: torch.Tensor, c0: torch.Tensor, plain_modulus: int,
                    q_mod_t: int, coeff_div_plain: Tuple[int, ...],
                    t: RnsNttTables, subtract: bool = False,
                    out: Optional[torch.Tensor] = None,
                    c1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BFV plain embedding c0 +/- round(Q/t * m) per limb (kernel G, one
    launch on D's grid). m: (..., n) mod t; c0: (..., k, n) with the same
    leading axes, G groups. ``out``: c0's shape, a new tensor if None, else
    any view whose (k, n) groups lie at one stride, such as c0 of a new
    ciphertext, and it may be c0 itself; ``c1`` (G, s, k, n), or (s, k, n)
    for one group: the s components copied after each of out's groups in
    the same launch (a ciphertext's c1, c2, ...). Returns out."""
    _check_rows(c0, t, "bfv_plain_embed")
    if m.shape != c0.shape[:-2] + c0.shape[-1:]:
        raise ValueError(f"bfv_plain_embed: m {tuple(m.shape)} does not "
                         f"match c0 {tuple(c0.shape)}")
    if out is None:
        if c1 is not None:
            raise ValueError("bfv_plain_embed: c1 needs out in a ciphertext")
        out = torch.empty_like(c0)
    if out.shape != c0.shape:
        raise ValueError(f"bfv_plain_embed: out {tuple(out.shape)}")
    kn = t.k * t.n
    G = c0.numel() // kn
    copies = 0 if c1 is None else c1.numel() // (G * kn)
    if c1 is not None and (copies < 1 or c1.numel() != G * copies * kn or
                           c1.shape[-2:] != c0.shape[-2:]):
        raise ValueError(f"bfv_plain_embed: c1 {tuple(c1.shape)} is not "
                         f"{G} group(s) of components")
    args = (plain_modulus, q_mod_t, coeff_div_plain)
    consts = _plain_embed_consts(*args, t)
    operands = [v for v in (m, c0, c1, out, consts) if v is not None]
    if not _kernels.on_cuda(*operands):
        out.copy_(bfv_multiply_add_plain(m, c0, *args, t, subtract))
        if c1 is not None:
            parts = c1.reshape((G, copies) + c1.shape[-2:])
            for j in range(copies):
                _c1_view(out, t, j + 1).copy_(
                    parts[:, j].reshape(out.shape))
        return out
    m, c0 = m.contiguous(), c0.contiguous()
    c1 = None if c1 is None else c1.contiguous()
    stride = _check_fused("bfv_plain_embed", out, t, m, c0, c1=c1,
                          copies=max(copies, 1))
    _kernels.launch("troy_bfv_plain_embed", out.get_device(), out, stride,
                    c0, m, t.n, c1, copies * kn, copies, int(subtract), G,
                    t.k, t.log_n, consts)
    return out


def bfv_plain_embed_c0(data: torch.Tensor, m: torch.Tensor,
                       plain_modulus: int, q_mod_t: int,
                       coeff_div_plain: Tuple[int, ...], t: RnsNttTables,
                       subtract: bool = False) -> torch.Tensor:
    """A new ciphertext: data (size, k, n) with round(Q m / t) added to
    (subtracted from) its c0 and its other components copied, one kernel-G
    launch: BFV's add_plain and sub_plain, the host-sampled encrypt's
    embed."""
    if data.dim() != 3:
        raise ValueError(f"bfv_plain_embed_c0: data {tuple(data.shape)}")
    out = torch.empty_like(data)
    bfv_plain_embed(m, data[0], plain_modulus, q_mod_t, coeff_div_plain, t,
                    subtract, out=out[0],
                    c1=data[1:] if data.shape[0] > 1 else None)
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
    _kernels.launch("troy_plain_lift", out.get_device(), out, m,
                    m.numel() // t.n, t.k, t.log_n, plain_upper_half_threshold,
                    cf, u.shoup_quotient(cf, tt), consts)
    return out


def plain_lift_ntt(m: torch.Tensor, t: RnsNttTables, plain_modulus: int,
                   plain_upper_half_threshold: int, total_q: int,
                   correction_factor: int = 1) -> torch.Tensor:
    """``plain_lift`` then the forward transform, routed by the tables: on
    A's route one A call with the lift in its first pass (AGp,
    ``ntt.rns_ntt_forward_lift``); on J's kernel G', then J."""
    args = (plain_modulus, plain_upper_half_threshold, total_q,
            correction_factor)
    if on_a_route(t):
        return rns_ntt_forward_lift(m, t, *args)
    return rns_ntt_forward(plain_lift(m, t, *args), t)


# --------------------------------------------------------------------------
# kernels N1 and N2: the negacyclic shift family and the pack-tree prepare
# --------------------------------------------------------------------------
#
# x^s mod x^n + 1 moves coefficient p to (p + s) mod n, negated where
# p + s (mod 2n) lies in [n, 2n); 0 stays 0 (troy_tpu/ops/poly.py:146). A
# shift is one int for every row or a device int64 array with one per
# leading batch index, any integer taken mod 2n.

Shift = Union[int, torch.Tensor]


def _shift_sources(shifts: torch.Tensor, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, neg), each (B, n): output j of row b is +-x[src[b, j]]."""
    s = (shifts & (2 * n - 1)).unsqueeze(-1)
    src = (torch.arange(n, device=shifts.device) - s) & (n - 1)
    return src, ((src + s) >> (n.bit_length() - 1)) & 1 == 1


def _shift_tensor(shift: Shift, device) -> torch.Tensor:
    if isinstance(shift, torch.Tensor):
        return shift
    return torch.tensor([int(shift)], dtype=torch.int64, device=device)


def negacyclic_shift_plain(x: torch.Tensor, shift: Shift, t: RnsNttTables,
                           scalars: Optional[Sequence[int]] = None
                           ) -> torch.Tensor:
    """The plain version of kernel N1's shift: x (B, ..., k, n) times x^s_b
    (or x (..., k, n) times x^shift), then times scalars_i mod q_i."""
    src, neg = _shift_sources(_shift_tensor(shift, x.device), t.n)
    lead = (src.shape[0],) + (1,) * (x.dim() - 2) + (t.n,)
    src, neg = src.reshape(lead), neg.reshape(lead)
    q = _col(t.q, x.dim() - 2, 1)
    out = x.gather(-1, src.expand(x.shape))
    out = torch.where(neg, u.neg_mod(out, q), out)
    if scalars is not None:
        w, wq = t.scalar_operand(scalars)
        L = x.dim() - 2
        out = u.mul_mod_shoup(out, _col(w, L, 1), _col(wq, L, 1), q)
    return out


def extract_lwe_many_plain(data: torch.Tensor, shifts: torch.Tensor,
                           t: RnsNttTables
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel N1's extract (troy_tpu/evaluator.py:647
    _extract_lwe_many_core)."""
    c1s = negacyclic_shift_plain(data[1].expand((shifts.shape[0],)
                                                + data.shape[1:]),
                                 shifts, t)
    terms = (2 * t.n - shifts) & (2 * t.n - 1)
    return c1s, data[0].index_select(-1, terms).transpose(0, 1)


def assemble_lwe_plain(c1s: torch.Tensor, c0s: torch.Tensor, terms: Shift,
                       t: RnsNttTables,
                       scalars: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
    """The plain version of kernel N1's assemble (troy_tpu/evaluator.py:674
    _pack_assemble_core, and :1374 assemble_lwe)."""
    b, k, n = c1s.shape
    terms = _shift_tensor(terms, c1s.device).expand(b)
    c1 = negacyclic_shift_plain(c1s, terms, t, scalars)
    c0 = torch.zeros_like(c1s)
    c0.scatter_(-1, terms.reshape(b, 1, 1).expand(b, k, 1),
                c0s.unsqueeze(-1))
    if scalars is not None:
        c0 = rns_elementwise_plain(SCALAR_MUL, c0, None, t,
                                   *t.scalar_operand(scalars))
    return torch.stack([c0, c1], dim=1)


def pack_fold_prepare_plain(cur: torch.Tensor, shift: int, t: RnsNttTables
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel N2 (troy_tpu/evaluator.py:573
    _pack_fold_prepare, coefficient domain)."""
    even = cur[0::2]
    temp = negacyclic_shift_plain(cur[1::2], shift, t)
    q = _col(t.q, cur.dim() - 2, 1)
    return u.add_mod(even, temp, q), u.sub_mod(even, temp, q)


def _shift_args(shift: Shift, batch: int, device):
    """(shifts tensor or None, scalar shift) for an N1 launch."""
    if isinstance(shift, torch.Tensor):
        if shift.shape != (batch,) or shift.dtype != torch.int64:
            raise ValueError(f"negacyclic shift: shifts {tuple(shift.shape)} "
                             f"{shift.dtype} for a batch of {batch}")
        return shift.contiguous(), 0
    return None, int(shift)


def negacyclic_shift(x: torch.Tensor, shift: Shift,
                     t: RnsNttTables) -> torch.Tensor:
    """x (..., k, n) times x^shift mod x^n + 1, or x (B, ..., k, n) with a
    device int64 array of B shifts, one per leading index (kernel N1, one
    launch). Words below q."""
    _check_rows(x, t, "negacyclic_shift")
    operands = [x, t.q] + ([shift] if isinstance(shift, torch.Tensor)
                           else [])
    if not _kernels.on_cuda(*operands):
        return negacyclic_shift_plain(x, shift, t)
    batch = x.shape[0] if isinstance(shift, torch.Tensor) else 1
    shifts, scalar = _shift_args(shift, batch, x.device)
    x = x.contiguous()
    _kernels.check_operand(x, "negacyclic_shift input")
    out = torch.empty_like(x)
    _kernels.launch("troy_negacyclic_shift", out.get_device(), out, x, shifts,
                    scalar, batch, x.numel() // (batch * t.n), t.k, t.log_n,
                    t.q)
    return out


def extract_lwe_many(data: torch.Tensor, shifts: torch.Tensor,
                     t: RnsNttTables) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LWE samples of a coefficient-form ciphertext (2, k, n) at the
    terms whose shifts 2n - term (0 for term 0) a device int64 array
    (B,) holds: (c1s (B, k, n), c1 times x^shift_b; c0s (B, k), the column
    term_b of c0) (kernel N1, one launch, c1 read once)."""
    _check_rows(data, t, "extract_lwe_many")
    if data.dim() != 3 or data.shape[0] != 2:
        raise ValueError(f"extract_lwe_many: expected (2, {t.k}, {t.n}), "
                         f"got {tuple(data.shape)}")
    if not _kernels.on_cuda(data, shifts, t.q):
        return extract_lwe_many_plain(data, shifts, t)
    batch = shifts.shape[0]
    shifts, _ = _shift_args(shifts, batch, data.device)
    data = data.contiguous()
    _kernels.check_operand(data, "extract_lwe_many data")
    c1s = torch.empty((batch, t.k, t.n), dtype=torch.int64,
                      device=data.device)
    c0s = torch.empty((batch, t.k), dtype=torch.int64, device=data.device)
    _kernels.launch("troy_extract_lwe", c1s.get_device(), c1s, c0s, data,
                    shifts, batch, t.k, t.log_n, t.q)
    return c1s, c0s


def assemble_lwe(c1s: torch.Tensor, c0s: torch.Tensor, terms: Shift,
                 t: RnsNttTables, scalars: Optional[Sequence[int]] = None
                 ) -> torch.Tensor:
    """LWE samples (c1s (B, k, n), c0s (B, k)) back to coefficient-form
    ciphertexts (B, 2, k, n) whose coefficient term_b carries the value: c1
    times x^term_b, c0 at that column and 0 elsewhere; both times
    scalars_i mod q_i if given (kernel N1, one launch). terms: one int, or
    a device int64 array (B,) in [0, n)."""
    _check_rows(c1s, t, "assemble_lwe")
    if c1s.dim() != 3 or c0s.shape != c1s.shape[:2]:
        raise ValueError(f"assemble_lwe: c1s {tuple(c1s.shape)} and c0s "
                         f"{tuple(c0s.shape)} do not fit")
    operands = [c1s, c0s, t.q] + ([terms] if isinstance(terms, torch.Tensor)
                                  else [])
    if not _kernels.on_cuda(*operands):
        return assemble_lwe_plain(c1s, c0s, terms, t, scalars)
    batch = c1s.shape[0]
    shifts, scalar = _shift_args(terms, batch, c1s.device)
    c1s, c0s = c1s.contiguous(), c0s.contiguous()
    _kernels.check_operand(c1s, "assemble_lwe c1s")
    _kernels.check_operand(c0s, "assemble_lwe c0s")
    out = torch.empty((batch, 2, t.k, t.n), dtype=torch.int64,
                      device=c1s.device)
    w, wq = (None, None) if scalars is None else t.scalar_operand(scalars)
    _kernels.launch("troy_assemble_lwe", out.get_device(), out, c1s, c0s,
                    shifts, scalar, batch, t.k, t.log_n, t.q, w, wq)
    return out


def pack_fold_prepare(cur: torch.Tensor, shift: int, t: RnsNttTables
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pack-tree layer's shift and fold, coefficient domain: cur
    (2m, 2, k, n) -> (even + x^shift odd, even - x^shift odd), each
    (m, 2, k, n), even and odd the ciphertexts at even and odd indices
    (kernel N2, one launch)."""
    _check_rows(cur, t, "pack_fold_prepare")
    if cur.dim() != 4 or cur.shape[1] != 2 or cur.shape[0] % 2:
        raise ValueError(f"pack_fold_prepare: expected (2m, 2, {t.k}, "
                         f"{t.n}), got {tuple(cur.shape)}")
    if not _kernels.on_cuda(cur, t.q):
        return pack_fold_prepare_plain(cur, shift, t)
    if t.k > 64:
        raise ValueError(f"pack_fold_prepare: {t.k} limbs; the kernel takes "
                         "at most 64")
    cur = cur.contiguous()
    _kernels.check_operand(cur, "pack_fold_prepare input")
    pairs = cur.shape[0] // 2
    even = torch.empty((pairs,) + cur.shape[1:], dtype=torch.int64,
                       device=cur.device)
    folded = torch.empty_like(even)
    _kernels.launch("troy_pack_fold_prepare", even.get_device(), even, folded,
                    cur, int(shift), pairs, t.k, t.log_n, t.q)
    return even, folded
