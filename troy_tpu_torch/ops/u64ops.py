"""64-bit modular arithmetic on torch int64 tensors that hold u64 words.

The int64 twin of troy_tpu/ops/u64ops.py. Torch has no uint64 arithmetic
on the CPU (add, shift and compare raise), so every residue lives in an
int64 tensor holding the u64 bit pattern. Addition, subtraction and
multiplication wrap mod 2^64 exactly like u64 on both CPU and CUDA; only
two operations differ and are written out here:

  * ``>>`` is arithmetic on int64, so a logical shift masks after shifting
    (``shr``);
  * ``<`` is signed, so a carry test on full-range words flips the sign bit
    of both sides first (``ult``).

Every modulus is below 2^61, so residues and lazy values in [0, 4q) are
positive and compare correctly as signed; only the words of 128-bit
products, Barrett ratio words and Shoup quotients use all 64 bits.

Moduli and constants may be Python ints (any u64 word) or int64 tensors
that broadcast against the data (the per-limb (k, 1) columns of the RNS
ops). The CUDA
kernels use the same algorithms in csrc/u64.cuh on uint64_t.
"""

from __future__ import annotations

import torch

M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def s64(v: int) -> int:
    """The int64 value whose bits are the u64 word ``v``."""
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def u64(x, device=None) -> torch.Tensor:
    """An int64 tensor of u64 words from a sequence of Python ints."""
    return torch.tensor([s64(int(v)) for v in x], dtype=torch.int64,
                        device=device)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 words by a static 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def ult(a, b) -> torch.Tensor:
    """Unsigned a < b on u64 words."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _const(c):
    """A u64 constant as the int64 Python int with its bits, or the tensor
    itself. PyTorch passes a Python int to its kernels as an argument;
    making a tensor of it would copy it to the device, with a stream
    synchronisation, on every call."""
    return s64(c) if isinstance(c, int) else c


def mulhi64(a, b) -> torch.Tensor:
    """High 64 bits of the 128-bit product a*b."""
    a_lo = a & _M32
    a_hi = shr(a, 32)
    b_lo = b & _M32
    b_hi = shr(b, 32)
    t = a_lo * b_lo
    u = a_hi * b_lo + shr(t, 32)
    v = a_lo * b_hi + (u & _M32)
    return a_hi * b_hi + shr(u, 32) + shr(v, 32)


def mul128(a, b):
    """Full 128-bit product as (lo64, hi64)."""
    a_lo = a & _M32
    a_hi = shr(a, 32)
    b_lo = b & _M32
    b_hi = shr(b, 32)
    t = a_lo * b_lo
    u = a_hi * b_lo + shr(t, 32)
    v = a_lo * b_hi + (u & _M32)
    lo = (v << 32) | (t & _M32)
    hi = a_hi * b_hi + shr(u, 32) + shr(v, 32)
    return lo, hi


def add_u128(lo_a, hi_a, lo_b, hi_b):
    """128-bit addition of two (lo, hi) pairs."""
    lo = lo_a + lo_b
    hi = hi_a + hi_b + ult(lo, lo_a).to(torch.int64)
    return lo, hi


def add_mod(a, b, q):
    """(a + b) mod q for a, b in [0, q)."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    """(a - b) mod q for a, b in [0, q)."""
    d = a - b
    return torch.where(a >= b, d, d + q)


def neg_mod(a, q):
    """(-a) mod q for a in [0, q)."""
    return torch.where(a == 0, a, q - a)


def barrett_reduce_64(x, q, const_ratio_hi):
    """Any u64 word to [0, q): one mulhi with the high ratio word, then one
    conditional subtract (uintarithsmallmod.h barrettReduce64)."""
    tmp = mulhi64(x, _const(const_ratio_hi))
    res = x - tmp * q
    return torch.where(res >= q, res - q, res)


def barrett_reduce_128(z_lo, z_hi, q, cr_lo, cr_hi):
    """A 128-bit value (z_hi:z_lo) to [0, q), with cr_hi:cr_lo =
    floor(2^128 / q) (uintarithsmallmod.h:95-163). The modulus and ratio
    words may be ints or tensors that broadcast against z (the
    ``barrett_reduce_128_dyn`` form of the JAX package)."""
    cr_lo = _const(cr_lo)
    cr_hi = _const(cr_hi)
    carry = mulhi64(z_lo, cr_lo)
    tmp2_lo, tmp2_hi = mul128(z_lo, cr_hi)
    tmp1 = tmp2_lo + carry
    tmp3 = tmp2_hi + ult(tmp1, tmp2_lo).to(torch.int64)
    tmp2_lo, tmp2_hi = mul128(z_hi, cr_lo)
    s = tmp1 + tmp2_lo
    carry = tmp2_hi + ult(s, tmp1).to(torch.int64)
    tmp1 = z_hi * cr_hi + tmp3 + carry
    r = z_lo - tmp1 * q
    return torch.where(r >= q, r - q, r)


def mul_mod(a, b, q, const_ratio):
    """(a * b) mod q by full Barrett reduction of the 128-bit product;
    const_ratio = (cr_lo, cr_hi, ...)."""
    lo, hi = mul128(a, b)
    return barrett_reduce_128(lo, hi, q, const_ratio[0], const_ratio[1])


def shoup_quotient(operand: int, q: int) -> int:
    """Host precompute: floor(operand * 2^64 / q)."""
    return (operand << 64) // q


def mul_mod_shoup_lazy(x, w, w_quot, q):
    """Shoup multiplication by a constant w < q, lazy result in [0, 2q);
    x may be any u64 word, w_quot = floor(w * 2^64 / q)."""
    return x * _const(w) - mulhi64(x, _const(w_quot)) * q


def mul_mod_shoup(x, w, w_quot, q):
    """Shoup multiplication fully reduced to [0, q)."""
    r = mul_mod_shoup_lazy(x, w, w_quot, q)
    return torch.where(r >= q, r - q, r)


def reduce_2q(x, q):
    """[0, 2q) -> [0, q)."""
    return torch.where(x >= q, x - q, x)


def reduce_4q(x, q):
    """[0, 4q) -> [0, q)."""
    x = torch.where(x >= 2 * q, x - 2 * q, x)
    return torch.where(x >= q, x - q, x)
