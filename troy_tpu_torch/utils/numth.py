"""Number theory on host Python integers.

Semantics-compatible with the reference's number-theory toolchain
(reference: src/utils/numth.h:16-140, src/utils/numth.cpp:163-380), but
implemented with arbitrary-precision Python ints instead of uint64 chains.

All functions here run at context-construction / key-generation time on the
host; nothing in this module is traced by JAX.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

# Deterministic Miller-Rabin witness set: provably correct for all n < 3.3e24,
# which covers every 64-bit modulus.  The reference uses 40 random rounds
# (numth.cpp:163-255); a deterministic witness set is strictly stronger for
# our domain and keeps prime generation reproducible.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(value: int) -> bool:
    """Primality test for 64-bit-range integers (exact)."""
    if value < 2:
        return False
    for p in _MR_WITNESSES:
        if value == p:
            return True
        if value % p == 0:
            return False
    d = value - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, value)
        if x == 1 or x == value - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % value
            if x == value - 1:
                break
        else:
            return False
    return True


def get_primes(factor: int, bit_size: int, count: int) -> List[int]:
    """Generate `count` primes of exactly `bit_size` bits congruent to
    1 mod `factor`, scanning downward from 2^bit_size - 1.

    Matches reference getPrimes (numth.cpp:261-285): start at
    ((2^bit_size - 1) // factor) * factor + 1, step down by `factor`,
    stop above 2^(bit_size-1).
    """
    if bit_size < 2 or bit_size > 62:
        raise ValueError("bit_size out of range [2, 62]")
    out: List[int] = []
    value = ((1 << bit_size) - 1) // factor * factor + 1
    lower_bound = 1 << (bit_size - 1)
    while count > 0 and value > lower_bound:
        if is_prime(value):
            out.append(value)
            count -= 1
        value -= factor
    if count > 0:
        raise RuntimeError("failed to find enough qualifying primes")
    return out


def get_prime(factor: int, bit_size: int) -> int:
    return get_primes(factor, bit_size, 1)[0]


def xgcd(x: int, y: int) -> Tuple[int, int, int]:
    """Extended GCD: returns (g, a, b) with g = a*x + b*y."""
    prev_a, a = 1, 0
    prev_b, b = 0, 1
    while y != 0:
        q = x // y
        x, y = y, x % y
        prev_a, a = a, prev_a - q * a
        prev_b, b = b, prev_b - q * b
    return x, prev_a, prev_b


def gcd(x: int, y: int) -> int:
    while y:
        x, y = y, x % y
    return x


def are_coprime(x: int, y: int) -> bool:
    return gcd(x, y) <= 1


def try_invert_mod(value: int, modulus: int) -> Tuple[bool, int]:
    """Modular inverse of value mod modulus; (ok, inverse)."""
    value %= modulus
    if value == 0:
        return False, 0
    g, a, _ = xgcd(value, modulus)
    if g != 1:
        return False, 0
    return True, a % modulus


def invert_mod(value: int, modulus: int) -> int:
    ok, r = try_invert_mod(value, modulus)
    if not ok:
        raise ValueError(f"{value} not invertible mod {modulus}")
    return r


def is_primitive_root(root: int, degree: int, modulus: int) -> bool:
    """Is `root` a primitive degree-th root of unity mod prime `modulus`?
    degree must be a power of two (numth.cpp:287-298)."""
    if root == 0:
        return False
    return pow(root, degree >> 1, modulus) == modulus - 1


def try_primitive_root(degree: int, modulus: int, seed: int = 0) -> Tuple[bool, int]:
    """Find some primitive degree-th root of unity mod `modulus`.

    The reference draws random candidates (numth.cpp:299-333); we scan
    deterministic candidates instead — the downstream minimal-root search
    makes the result identical either way.
    """
    size_entire_group = modulus - 1
    size_quotient_group = size_entire_group // degree
    if size_entire_group - size_quotient_group * degree != 0:
        return False, 0
    candidate = 2 + seed
    for _ in range(200):
        root = pow(candidate, size_quotient_group, modulus)
        if is_primitive_root(root, degree, modulus):
            return True, root
        candidate += 1
    return False, 0


def try_minimal_primitive_root(degree: int, modulus: int) -> Tuple[bool, int]:
    """Smallest primitive degree-th root of unity mod `modulus`
    (numth.cpp:335-366). Deterministic — this anchors NTT tables."""
    ok, root = try_primitive_root(degree, modulus)
    if not ok:
        return False, 0
    generator_sq = (root * root) % modulus
    current = root
    best = root
    for _ in range(0, degree, 2):
        if current < best:
            best = current
        current = (current * generator_sq) % modulus
    return True, best


@lru_cache(maxsize=None)
def minimal_primitive_root(degree: int, modulus: int) -> int:
    # deterministic per (degree, modulus); cached because context/NTT/MXU
    # table construction each ask for the same root (the search walks
    # degree/2 modmuls in Python)
    ok, r = try_minimal_primitive_root(degree, modulus)
    if not ok:
        raise ValueError(f"no primitive {degree}-th root mod {modulus}")
    return r


def naf(value: int) -> List[int]:
    """Non-adjacent form decomposition: returns signed powers-of-two terms
    whose sum is `value` (numth.h:16-36). Used for rotation-step splitting."""
    res: List[int] = []
    sign = value < 0
    value = abs(value)
    i = 0
    while value:
        zi = (2 - (value & 3)) if (value & 1) else 0
        value = (value - zi) >> 1
        if zi:
            res.append((-zi if sign else zi) * (1 << i))
        i += 1
    return res


def reverse_bits(value: int, bit_count: int) -> int:
    """Bit-reverse the low `bit_count` bits of value."""
    result = 0
    for _ in range(bit_count):
        result = (result << 1) | (value & 1)
        value >>= 1
    return result


def get_power_of_two(value: int) -> int:
    """log2(value) if value is a power of two, else -1."""
    if value == 0 or (value & (value - 1)) != 0:
        return -1
    return value.bit_length() - 1


def multiplicative_orders(conjugate_classes: List[int], modulus: int) -> List[int]:
    orders = []
    for cls in conjugate_classes:
        if cls <= 1:
            orders.append(cls)
            continue
        if conjugate_classes[cls] != cls:
            orders.append(conjugate_classes[cls])
            continue
        d = 1
        x = cls
        while x != 1:
            x = (x * cls) % modulus
            d += 1
        orders.append(d)
    return orders


def conjugate_classes(modulus: int, subgroup_generator: int) -> List[int]:
    classes = []
    for i in range(modulus):
        if gcd(i, modulus) > 1:
            classes.append(0)
        else:
            classes.append(i)
    for i in range(modulus):
        if classes[i] == 0:
            continue
        if classes[i] < i:
            classes[i] = classes[classes[i]]
            continue
        j = (i * subgroup_generator) % modulus
        while classes[j] != j:
            classes[j] = classes[i]
            j = (j * subgroup_generator) % modulus
    return classes
