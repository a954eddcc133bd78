"""Vectorized numpy NTT + modular helpers — the host compute path.

The reference generates every key on the CPU and uploads the result
(reference: src/keygenerator_cuda.cuh:51-85 — KeyGeneratorCuda wraps a
host KeyGenerator). This module gives our keygen the same architecture:
a numpy twin of the device butterfly network (ops/ntt.py) producing
IDENTICAL words (both are the canonical fully-reduced transform under the
same table/ordering contract), so one-shot setup work costs no device
executable compile/load at all — the finished key array is uploaded once.

All arithmetic is uint64 with explicit 32-bit-split widening (numpy u64
wraps mod 2^64 exactly like the device ops in ops/u64ops.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .ntt_tables import NttTablesHost, make_ntt_tables

_M32 = np.uint64(0xFFFFFFFF)
_32 = np.uint64(32)

# numpy warns on uint64 overflow in some reduction paths; wraparound is
# intentional throughout (device semantics)
_err = np.seterr(over="ignore")


def mulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 64 bits of the 128-bit product (u64ops.mulhi64 twin)."""
    a_lo = a & _M32
    a_hi = a >> _32
    b_lo = b & _M32
    b_hi = b >> _32
    t = a_lo * b_lo
    u = a_hi * b_lo + (t >> _32)
    v = a_lo * b_hi + (u & _M32)
    return a_hi * b_hi + (u >> _32) + (v >> _32)


def mul128(a: np.ndarray, b: np.ndarray):
    a_lo = a & _M32
    a_hi = a >> _32
    b_lo = b & _M32
    b_hi = b >> _32
    t = a_lo * b_lo
    u = a_hi * b_lo + (t >> _32)
    v = a_lo * b_hi + (u & _M32)
    lo = (v << _32) | (t & _M32)
    hi = a_hi * b_hi + (u >> _32) + (v >> _32)
    return lo, hi


def barrett_reduce_128(z_lo, z_hi, q: int, const_ratio) -> np.ndarray:
    """(z_hi:z_lo) mod q (u64ops.barrett_reduce_128 twin)."""
    cr0 = np.uint64(const_ratio[0])
    cr1 = np.uint64(const_ratio[1])
    qs = np.uint64(q)
    carry = mulhi64(z_lo, cr0)
    tmp2_lo, tmp2_hi = mul128(z_lo, cr1)
    tmp1 = tmp2_lo + carry
    c = (tmp1 < tmp2_lo).astype(np.uint64)
    tmp3 = tmp2_hi + c
    tmp2_lo, tmp2_hi = mul128(z_hi, cr0)
    s = tmp1 + tmp2_lo
    c = (s < tmp1).astype(np.uint64)
    tmp1 = s
    carry = tmp2_hi + c
    tmp1 = z_hi * cr1 + tmp3 + carry
    tmp3 = z_lo - tmp1 * qs
    return np.where(tmp3 >= qs, tmp3 - qs, tmp3)


def mul_mod(a, b, q: int, const_ratio) -> np.ndarray:
    lo, hi = mul128(np.asarray(a, np.uint64), np.asarray(b, np.uint64))
    return barrett_reduce_128(lo, hi, q, const_ratio)


def add_mod(a, b, q: int) -> np.ndarray:
    qs = np.uint64(q)
    s = a + b
    return np.where(s >= qs, s - qs, s)


def neg_mod(a, q: int) -> np.ndarray:
    qs = np.uint64(q)
    return np.where(a == np.uint64(0), a, qs - a)


def mul_mod_shoup_lazy(x, w, w_quot, q: int) -> np.ndarray:
    return x * w - mulhi64(x, w_quot) * np.uint64(q)


def ntt_forward_np(x: np.ndarray, t: NttTablesHost) -> np.ndarray:
    """Forward negacyclic NTT over the last axis — numpy twin of
    ops/ntt.py ntt_forward (same tables, same Harvey lazy bounds, fully
    reduced output; identical words to the device transform)."""
    n, q = t.n, t.modulus
    qs = np.uint64(q)
    q2 = np.uint64(2 * q)
    lead = x.shape[:-1]
    v = np.asarray(x, dtype=np.uint64)
    for r in range(t.log_n):
        m = 1 << r
        gap = n >> (r + 1)
        w = t.root_powers[m:2 * m].reshape((1,) * len(lead) + (m, 1))
        wq = t.root_powers_shoup[m:2 * m].reshape((1,) * len(lead) + (m, 1))
        v = v.reshape(lead + (m, 2, gap))
        a = v[..., 0, :]
        b = v[..., 1, :]
        a = np.where(a >= q2, a - q2, a)
        bw = mul_mod_shoup_lazy(b, w, wq, q)
        v = np.stack([a + bw, a - bw + q2], axis=-2)
        v = v.reshape(lead + (n,))
    v = np.where(v >= q2, v - q2, v)
    return np.where(v >= qs, v - qs, v)


def ntt_inverse_np(x: np.ndarray, t: NttTablesHost) -> np.ndarray:
    """Inverse negacyclic NTT incl. the n^{-1} scaling — numpy twin of
    ops/ntt.py ntt_inverse."""
    n, q = t.n, t.modulus
    qs = np.uint64(q)
    q2 = np.uint64(2 * q)
    lead = x.shape[:-1]
    v = np.asarray(x, dtype=np.uint64)
    for r in range(t.log_n - 1, -1, -1):
        m = 1 << r
        gap = n >> (r + 1)
        w = t.inv_root_powers[m:2 * m].reshape((1,) * len(lead) + (m, 1))
        wq = t.inv_root_powers_shoup[m:2 * m].reshape(
            (1,) * len(lead) + (m, 1))
        v = v.reshape(lead + (m, 2, gap))
        a = v[..., 0, :]
        b = v[..., 1, :]
        s = a + b
        d = a - b + q2
        s = np.where(s >= q2, s - q2, s)
        bw = mul_mod_shoup_lazy(d, w, wq, q)
        v = np.stack([s, bw], axis=-2)
        v = v.reshape(lead + (n,))
    v = mul_mod_shoup_lazy(v, np.uint64(t.inv_degree),
                           np.uint64(t.inv_degree_shoup), q)
    return np.where(v >= qs, v - qs, v)


def rns_ntt_forward_np(x: np.ndarray, n: int,
                       moduli: Sequence[int]) -> np.ndarray:
    """(k, n) -> (k, n) forward NTT of every limb."""
    return np.stack([ntt_forward_np(x[i], make_ntt_tables(n, int(q)))
                     for i, q in enumerate(moduli)])


def rns_ntt_inverse_np(x: np.ndarray, n: int,
                       moduli: Sequence[int]) -> np.ndarray:
    return np.stack([ntt_inverse_np(x[i], make_ntt_tables(n, int(q)))
                     for i, q in enumerate(moduli)])


def rns_dyadic_mul_np(a: np.ndarray, b: np.ndarray, n: int,
                      moduli: Sequence[int]) -> np.ndarray:
    """(k, n) pointwise product mod each limb's modulus."""
    out = np.empty_like(a)
    for i, q in enumerate(moduli):
        t = make_ntt_tables(n, int(q))
        out[i] = mul_mod(a[i], b[i], int(q), t.const_ratio)
    return out
