"""Host-side NTT table precomputation.

Computes, per (n, modulus) pair, the negacyclic-NTT root-power tables in
"scrambled" (bit-reversed index) order together with their Shoup quotients.
Semantics anchor: reference src/utils/ntt.h:66-268 / ntt.cpp (SEAL layout:
root_powers[brv(k)] = psi^k), re-derived for a vectorized butterfly network.

Output-ordering contract (shared with the encoders and Galois tooling):
forward NTT output index j holds the evaluation of the input polynomial at
psi^(2*brv(j, log2 n) + 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np

from . import numth


def _np_u64(values) -> np.ndarray:
    return np.array([v & 0xFFFFFFFFFFFFFFFF for v in values], dtype=np.uint64)


@dataclass(frozen=True)
class NttTablesHost:
    """Immutable host tables for one (n, q) pair. All arrays are numpy u64."""

    n: int
    log_n: int
    modulus: int
    const_ratio: Tuple[int, int, int]
    root: int                      # minimal primitive 2n-th root of unity
    inv_root: int
    root_powers: np.ndarray        # [n]; root_powers[brv(k)] = root^k
    root_powers_shoup: np.ndarray
    inv_root_powers: np.ndarray    # elementwise inverse of root_powers
    inv_root_powers_shoup: np.ndarray
    inv_degree: int                # n^{-1} mod q
    inv_degree_shoup: int


@lru_cache(maxsize=None)
def make_ntt_tables(n: int, modulus: int) -> NttTablesHost:
    log_n = numth.get_power_of_two(n)
    if log_n < 0:
        raise ValueError("n must be a power of two")
    q = modulus
    ratio, rem = divmod(1 << 128, q)
    const_ratio = (ratio & ((1 << 64) - 1), ratio >> 64, rem)

    root = numth.minimal_primitive_root(2 * n, q)
    inv_root = numth.invert_mod(root, q)

    shoup = lambda w: (w << 64) // q
    inv_degree = numth.invert_mod(n, q)

    # powers of root scattered to bit-reversed positions; inverses by
    # powering inv_root (one inversion total)
    powers = [0] * n
    inv_powers = [0] * n
    acc = inv_acc = 1
    for k in range(n):
        b = numth.reverse_bits(k, log_n)
        powers[b] = acc
        inv_powers[b] = inv_acc
        acc = (acc * root) % q
        inv_acc = (inv_acc * inv_root) % q
    powers_np = _np_u64(powers)
    powers_shoup_np = _np_u64([shoup(p) for p in powers])
    inv_powers_np = _np_u64(inv_powers)
    inv_powers_shoup_np = _np_u64([shoup(p) for p in inv_powers])

    return NttTablesHost(
        n=n,
        log_n=log_n,
        modulus=q,
        const_ratio=const_ratio,
        root=root,
        inv_root=inv_root,
        root_powers=powers_np,
        root_powers_shoup=powers_shoup_np,
        inv_root_powers=inv_powers_np,
        inv_root_powers_shoup=inv_powers_shoup_np,
        inv_degree=inv_degree,
        inv_degree_shoup=shoup(inv_degree),
    )


def naive_negacyclic_ntt(x: np.ndarray, tables: NttTablesHost) -> np.ndarray:
    """O(n^2) reference forward NTT (for tests). Output index j = evaluation
    at psi^(2*brv(j)+1)."""
    n, q = tables.n, tables.modulus
    psi = tables.root
    out = np.zeros(n, dtype=np.uint64)
    xs = [int(v) for v in x]
    for j in range(n):
        e = 2 * numth.reverse_bits(j, tables.log_n) + 1
        point = pow(psi, e, q)
        acc = 0
        p = 1
        for c in xs:
            acc = (acc + c * p) % q
            p = (p * point) % q
        out[j] = acc
    return out


def naive_negacyclic_mul(a, b, n: int, q: int) -> np.ndarray:
    """O(n^2) negacyclic polynomial product mod (x^n + 1, q) (for tests)."""
    res = [0] * n
    a = [int(v) for v in a]
    b = [int(v) for v in b]
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                res[k] = (res[k] + a[i] * b[j]) % q
            else:
                res[k - n] = (res[k - n] - a[i] * b[j]) % q
    return _np_u64(res)
