"""A plain BFV reference in NumPy, independent of the program under test.

It knows only what SEAL publishes: how ``CoeffModulus::Create`` picks its
primes, that a ciphertext (c0, c1) in coefficient form decrypts to
m = round(t (c0 + c1 s) / Q) mod t, with Q the product of the data primes
(every prime of the chain but the last, the special prime). Every product
of a word by the secret key is exact: the words are cut into 16-bit
pieces, each piece's negacyclic product with the ternary key is a float64 FFT whose
result stays below 2^32 and is rounded to the integer it lies next to
(checked), and the pieces are put together again modulo each prime.

This module imports numpy only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

CHUNK_BITS = 16
# the largest distance of an exact FFT product from an integer; the
# products here lie within 2^-12 of one, far inside it
ROUND_SLACK = 0.25


def is_prime(v: int) -> bool:
    """Deterministic Miller-Rabin for v < 2^64."""
    if v < 2:
        return False
    small = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    for p in small:
        if v % p == 0:
            return v == p
    d, r = v - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for a in small:
        x = pow(a, d, v)
        if x in (1, v - 1):
            continue
        for _ in range(r - 1):
            x = x * x % v
            if x == v - 1:
                break
        else:
            return False
    return True


def seal_primes(n: int, bit_sizes: Sequence[int]) -> list:
    """SEAL's ``CoeffModulus::Create(n, bit_sizes)``: for each size the
    primes = 1 mod 2n below 2^size, largest first, handed out from the
    smallest of those a size needs."""
    factor = 2 * n
    table = {}
    for size in sorted(set(bit_sizes)):
        need = list(bit_sizes).count(size)
        value = ((1 << size) - 1) // factor * factor + 1
        found = []
        while len(found) < need and value > (1 << (size - 1)):
            if is_prime(value):
                found.append(value)
            value -= factor
        if len(found) < need:
            raise ValueError(f"not enough {size}-bit primes for n = {n}")
        table[size] = found
    return [table[size].pop() for size in bit_sizes]


def ternary_secret(rng: np.random.Generator, n: int) -> np.ndarray:
    """A secret key's coefficients, uniform in {-1, 0, 1}, int8."""
    return rng.integers(-1, 2, n).astype(np.int8)


def _negacyclic_chunks(pieces: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Exact negacyclic products of integer rows ``pieces`` (..., n) with
    the small integer polynomial s (n,), as int64; raises if a float64
    product is not next to an integer."""
    n = s.shape[-1]
    fs = np.fft.rfft(s.astype(np.float64), 2 * n)
    full = np.fft.irfft(np.fft.rfft(pieces.astype(np.float64), 2 * n) * fs,
                        2 * n)
    rounded = np.rint(full)
    if np.abs(full - rounded).max(initial=0.0) > ROUND_SLACK:
        raise ArithmeticError("an FFT product is not exact")
    rounded = rounded.astype(np.int64)
    return rounded[..., :n] - rounded[..., n:]


def _shift_mod(acc: np.ndarray, bits: int, q: np.ndarray) -> np.ndarray:
    """acc 2^bits mod q, for 0 <= acc < q < 2^61, in int64 steps that
    cannot overflow."""
    step = 62 - int(q.max()).bit_length()
    while bits > 0:
        k = min(step, bits)
        acc = (acc << k) % q
        bits -= k
    return acc


def times_secret(words: np.ndarray, s: np.ndarray, primes: Sequence[int],
                 exact: bool = True) -> np.ndarray:
    """(words (L, n) u64, each row mod primes[i]) * s in Z[x]/(x^n + 1),
    mod each prime, as u64. ``exact=False`` is the lower precision: one
    float64 FFT of the whole 60-bit words, as an FP64 product would take
    it (the control)."""
    q = np.asarray(primes, dtype=np.int64)[:, None]
    if not exact:
        n = s.shape[-1]
        full = np.fft.irfft(np.fft.rfft(words.astype(np.float64), 2 * n)
                            * np.fft.rfft(s.astype(np.float64), 2 * n), 2 * n)
        whole = np.fmod(np.rint(full[:, :n] - full[:, n:]),
                        q.astype(np.float64))
        return (whole.astype(np.int64) % q).astype(np.uint64)
    w = words.astype(np.uint64)
    top = max(int(p).bit_length() for p in primes)
    chunks = -(-top // CHUNK_BITS)
    mask = np.uint64((1 << CHUNK_BITS) - 1)
    pieces = np.stack([(w >> np.uint64(CHUNK_BITS * c)) & mask
                       for c in range(chunks)])           # (chunks, L, n)
    prods = _negacyclic_chunks(pieces.astype(np.int64), s)
    acc = prods[chunks - 1] % q
    for c in range(chunks - 2, -1, -1):
        acc = (_shift_mod(acc, CHUNK_BITS, q) + prods[c] % q) % q
    return acc.astype(np.uint64)


def poly_mul_mod(a: np.ndarray, b: np.ndarray, t: int) -> np.ndarray:
    """a b in Z_t[x]/(x^n + 1) for words below t < 2^42, exactly: both cut
    into pieces of 11 bits, each pair's FFT product below 2^39."""
    bits, k = 11, -(-int(t - 1).bit_length() // 11)
    mask = np.uint64((1 << bits) - 1)
    au, bu = a.astype(np.uint64), b.astype(np.uint64)
    pa = [((au >> np.uint64(bits * i)) & mask).astype(np.int64)
          for i in range(k)]
    pb = [((bu >> np.uint64(bits * i)) & mask).astype(np.int64)
          for i in range(k)]
    total = np.zeros(a.shape[-1], dtype=object)
    for i in range(k):
        prods = _negacyclic_chunks(np.stack(pa), pb[i])   # pa[j] * pb[i]
        for j in range(k):
            total = total + prods[j].astype(object) * (1 << (bits * (i + j)))
    return (total % t).astype(np.uint64)


class Bfv:
    """Decryption and encryption of coefficient-form BFV ciphertexts under
    a ternary secret s, at the data primes of one level."""

    def __init__(self, primes: Sequence[int], t: int, s: np.ndarray):
        self.primes = [int(p) for p in primes]
        self.t = int(t)
        self.s = np.asarray(s, dtype=np.int8)
        self.Q = 1
        for p in self.primes:
            self.Q *= p
        self.crt = [(self.Q // p) * pow(self.Q // p, -1, p) for p in self.primes]
        self.delta = self.Q // self.t

    def phase(self, c: np.ndarray) -> np.ndarray:
        """c0 + c1 s composed to integers in [0, Q) (object (n,)); c is
        (2, L, n) u64."""
        if c.shape[0] != 2 or c.shape[1] != len(self.primes):
            raise ValueError(f"ciphertext of shape {c.shape}: expected "
                             f"(2, {len(self.primes)}, n)")
        q = np.asarray(self.primes, dtype=np.uint64)[:, None]
        prod = times_secret(c[1], self.s, self.primes)
        v = (c[0].astype(np.uint64) % q + prod) % q
        total = np.zeros(c.shape[-1], dtype=object)
        for row, coef in zip(v, self.crt):
            total = total + row.astype(object) * coef
        return total % self.Q

    def decrypt(self, c: np.ndarray) -> tuple:
        """(m mod t as u64 (n,), the noise budget in bits as SEAL counts
        it: bits(Q) - bits(max |[t v]_Q|) - 1)."""
        v = self.phase(c) * self.t
        m = (v + self.Q // 2) // self.Q
        e = v - m * self.Q
        worst = max(int(abs(x)) for x in e)
        budget = max(0, self.Q.bit_length() - worst.bit_length() - 1)
        return (m % self.t).astype(np.uint64), budget

    def encrypt(self, m: np.ndarray, rng: np.random.Generator,
                exact: bool = True) -> np.ndarray:
        """A fresh (2, L, n) u64 encryption of m (u64 words below t):
        c1 uniform, c0 = Delta m + e - c1 s with e in [-3, 3];
        ``exact=False`` takes c1 s in float64 (the control)."""
        n = m.shape[-1]
        q = np.asarray(self.primes, dtype=np.uint64)[:, None]
        c1 = np.stack([rng.integers(0, p, n, dtype=np.uint64)
                       for p in self.primes])
        e = rng.integers(-3, 4, n)
        dm = m.astype(object) * self.delta + e
        base = np.stack([(dm % p).astype(np.uint64) for p in self.primes])
        c0 = (base + q - times_secret(c1, self.s, self.primes, exact)) % q
        return np.stack([c0, c1])
