"""The least time of a request's algorithmic work on one H100, and the
counts behind it.

A request's work is counted from its shapes and SEAL's algorithms
(BEHZ multiplication, the hybrid key switch with one special prime,
troy's tile contraction), never from the kernels or
fusions the program happens to use, so that a later fusion cannot make a
count stale:

- bytes: every operand (ciphertexts, plaintexts), every key row the
  request uses and every output, each read or written once, 8 bytes a
  word;
- operations: the algorithm's modular products, 3 64-bit products each
  (Shoup's or Barrett's reduction), a butterfly of an NTT one modular
  product, and each 64-bit product 4 operations.

Peaks (NVIDIA's H100 SXM data sheet, 700 W): 3.35 TB/s of HBM3. The card
has no 64-bit integer multiplier and no published integer peak outside
the tensor cores; the integer rate is assumed to be the 67 T/s of its
float32 FMA units, with a 64-bit product counted as 4 of their operations
(``OPS_PER_MUL64``). That rate is an assumption and errs high: the
card's int32 multiply-add rate is half its float32 rate, so a bound set by
operations is, if anything, too low and a share of it too small.
"""

from __future__ import annotations

WORD = 8
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_PER_MUL64 = 4
MUL64_PER_MULMOD = 3


def least_seconds(nbytes: int, mul64: int) -> tuple:
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    mem = nbytes / MEM_BYTES_PER_S
    ops = mul64 * OPS_PER_MUL64 / OPS_PER_S
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def ntt_rows(rows: int, n: int) -> int:
    """Modular products of NTTs over ``rows`` rows of n words: n/2 log2 n
    butterflies and one scaling product a word."""
    return rows * ((n // 2) * (n.bit_length() - 1) + n)


def _shape(cfg: dict) -> tuple:
    """(n, L data primes, K = L + 1 primes of SEAL's base Bsk)."""
    L = len(cfg["coeff_modulus"]) - 1
    return cfg["poly_modulus_degree"], L, L + 1


def ct_words(cfg: dict, size: int = 2) -> int:
    n, L, _ = _shape(cfg)
    return size * L * n


def key_words(cfg: dict) -> int:
    """One switching key: L rows of (2, L + 1, n)."""
    n, L, _ = _shape(cfg)
    return L * 2 * (L + 1) * n


def behz_lift(cfg: dict, polys: int) -> int:
    """Modular products of lifting ``polys`` polynomials from q to q u Bsk
    u {m~} (fast base conversion and the Montgomery step) and taking their
    NTTs over q u Bsk."""
    n, L, K = _shape(cfg)
    return polys * (n * (L + L * (K + 1) + 2 * K) + ntt_rows(L + K, n))


def behz_finish(cfg: dict, polys: int) -> int:
    """Modular products of the inverse NTTs of ``polys`` product polynomials
    over q u Bsk, their scaling by t, the floor division by q (q to Bsk)
    and the conversion back to q (Shenoy-Kumaresan)."""
    n, L, K = _shape(cfg)
    return polys * (ntt_rows(L + K, n) + n * (L + K)
                    + n * (L + L * K + K) + n * (K + K * L + 2 * L))


def tensor(cfg: dict, pairs: int) -> int:
    """Modular products of ``pairs`` size-2 x size-2 products over q u Bsk."""
    n, L, K = _shape(cfg)
    return pairs * 4 * (L + K) * n


def bfv_multiply(cfg: dict) -> int:
    """BEHZ multiplication of two size-2 ciphertexts."""
    return behz_lift(cfg, 4) + tensor(cfg, 1) + behz_finish(cfg, 3)


def key_switch(cfg: dict) -> int:
    """The key switch of one coefficient-form polynomial: L digits NTT'd in
    L + 1 primes, the products with the key's 2 (L + 1) rows of L terms,
    two inverse NTTs over L + 1 primes and the division by the special
    prime."""
    n, L, _ = _shape(cfg)
    return (ntt_rows(L * (L + 1), n) + 2 * (L + 1) * L * n
            + ntt_rows(2 * (L + 1), n) + 2 * L * n)


def mul64(mulmods: int) -> int:
    return mulmods * MUL64_PER_MULMOD
