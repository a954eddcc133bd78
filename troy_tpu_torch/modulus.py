"""Modulus type, security tables, and coefficient-modulus factories.

Semantics-compatible with the reference's modulus layer
(reference: src/modulus.h:16-553, src/utils/hestdparams.h:23-111,
src/utils/globals.cpp:10-170), re-hosted on Python ints: the Barrett
const-ratio is precomputed exactly as floor(2^128 / q) and exposed as
64-bit words for the device kernels.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from .utils import numth

MOD_BIT_COUNT_MAX = 61          # internal moduli (SEAL_MOD_BIT_COUNT_MAX)
USER_MOD_BIT_COUNT_MAX = 60     # user-facing moduli
PLAIN_MOD_BIT_COUNT_MAX = 60
# The reference caps N at 131072 because its scaling unit is one GPU
# (reference: src/utils/defines.h:30 SEAL_POLY_MOD_DEGREE_MAX).
# Coefficient sharding over a device mesh lifts that: degrees beyond the
# reference's ceiling run end-to-end (benchmarks/nceiling.py at 262144,
# bit-exact vs a single-device replay). The cap below is a sanity bound
# on table precompute, not a device limit.
POLY_MOD_DEGREE_MAX = 1 << 20
POLY_MOD_DEGREE_MIN = 2
CIPHERTEXT_SIZE_MAX = 16
CIPHERTEXT_SIZE_MIN = 2
COEFF_MOD_COUNT_MAX = 64
INTERNAL_MOD_BIT_COUNT = 61     # bit size of RNSTool auxiliary-base primes


class SecurityLevel(enum.IntEnum):
    none = 0
    tc128 = 128
    tc192 = 192
    tc256 = 256


# HomomorphicEncryption.org standard: max total coeff-modulus bits for a
# ternary-secret classical-security parameter set (hestdparams.h:23-111).
_HE_STD_PARMS = {
    SecurityLevel.tc128: {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881},
    SecurityLevel.tc192: {1024: 19, 2048: 37, 4096: 75, 8192: 152, 16384: 305, 32768: 611},
    SecurityLevel.tc256: {1024: 14, 2048: 29, 4096: 58, 8192: 118, 16384: 237, 32768: 476},
}


def he_std_max_coeff_bits(poly_modulus_degree: int, sec: SecurityLevel) -> int:
    if sec == SecurityLevel.none:
        return 2 ** 31 - 1
    table = _HE_STD_PARMS[sec]
    if poly_modulus_degree in table:
        return table[poly_modulus_degree]
    if poly_modulus_degree % 32768 == 0:
        return table[32768] * (poly_modulus_degree // 32768)
    return 0


class _CallableBool(int):
    """Truthy like a bool but also callable — the reference binds
    Modulus::isPrime as a *method* (binder.cu:168) while troy_tpu exposes
    it as an attribute; this type serves both call sites."""

    __slots__ = ()

    def __call__(self) -> bool:
        return bool(self)

    def __repr__(self) -> str:
        return repr(bool(self))


class _CallableInt(int):
    """Int that also answers ``value()`` calls — the reference binds
    Modulus::value as a *method* (binder.cu:169) while troy_tpu exposes it
    as an attribute; this type serves both call sites."""

    __slots__ = ()

    def __call__(self) -> int:
        return int(self)


@dataclass(frozen=True)
class Modulus:
    """An integer modulus q < 2^61 with a precomputed Barrett ratio
    floor(2^128 / q) stored as three 64-bit words (modulus.h:16-124)."""

    value: int
    const_ratio: tuple = field(init=False)   # (lo64, hi64, remainder)
    bit_count: int = field(init=False)
    is_prime: bool = field(init=False)

    def __post_init__(self):
        v = int(self.value)
        object.__setattr__(self, "value", _CallableInt(v))
        if v != 0:
            if v >> MOD_BIT_COUNT_MAX or v <= 1:
                raise ValueError(f"modulus {v} out of range (2, 2^61)")
            ratio, rem = divmod(1 << 128, v)
            object.__setattr__(self, "const_ratio",
                               (ratio & ((1 << 64) - 1), ratio >> 64, rem))
            object.__setattr__(self, "bit_count", v.bit_length())
            object.__setattr__(self, "is_prime",
                               _CallableBool(numth.is_prime(v)))
        else:
            object.__setattr__(self, "const_ratio", (0, 0, 0))
            object.__setattr__(self, "bit_count", 0)
            object.__setattr__(self, "is_prime", _CallableBool(False))

    def is_zero(self) -> bool:
        return self.value == 0

    def reduce(self, x: int) -> int:
        if self.value == 0:
            raise ValueError("reduce by zero modulus")
        return x % self.value

    def __int__(self) -> int:
        return int.__int__(self.value)   # plain int (not the callable shim)

    def __eq__(self, other) -> bool:
        if isinstance(other, Modulus):
            return self.value == other.value
        return self.value == other

    def __hash__(self) -> int:
        return hash(self.value)

    def __repr__(self) -> str:
        return f"Modulus({self.value:#x})"


def _mods(vals: Sequence[int]) -> List[Modulus]:
    return [Modulus(v) for v in vals]


# Default coefficient-modulus chains per security level — the public
# Microsoft SEAL 4.0 constants (globals.cpp:10-170).
_DEFAULT_COEFF_128: Dict[int, List[int]] = {
    1024: [0x7E00001],
    2048: [0x3FFFFFFF000001],
    4096: [0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001],
    8192: [0x7FFFFFD8001, 0x7FFFFFC8001, 0xFFFFFFFC001, 0xFFFFFF6C001, 0xFFFFFEBC001],
    16384: [0xFFFFFFFD8001, 0xFFFFFFFA0001, 0xFFFFFFF00001, 0x1FFFFFFF68001, 0x1FFFFFFF50001,
            0x1FFFFFFEE8001, 0x1FFFFFFEA0001, 0x1FFFFFFE88001, 0x1FFFFFFE48001],
    32768: [0x7FFFFFFFE90001, 0x7FFFFFFFBF0001, 0x7FFFFFFFBD0001, 0x7FFFFFFFBA0001, 0x7FFFFFFFAA0001,
            0x7FFFFFFFA50001, 0x7FFFFFFF9F0001, 0x7FFFFFFF7E0001, 0x7FFFFFFF770001, 0x7FFFFFFF380001,
            0x7FFFFFFF330001, 0x7FFFFFFF2D0001, 0x7FFFFFFF170001, 0x7FFFFFFF150001, 0x7FFFFFFEF00001,
            0xFFFFFFFFF70001],
}

_DEFAULT_COEFF_192: Dict[int, List[int]] = {
    1024: [0x7F001],
    2048: [0x1FFFFC0001],
    4096: [0x1FFC001, 0x1FCE001, 0x1FC0001],
    8192: [0x3FFFFAC001, 0x3FFFF54001, 0x3FFFF48001, 0x3FFFF28001],
    16384: [0x3FFFFFFDF0001, 0x3FFFFFFD48001, 0x3FFFFFFD20001, 0x3FFFFFFD18001, 0x3FFFFFFCD0001,
            0x3FFFFFFC70001],
    32768: [0x3FFFFFFFD60001, 0x3FFFFFFFCA0001, 0x3FFFFFFF6D0001, 0x3FFFFFFF5D0001, 0x3FFFFFFF550001,
            0x7FFFFFFFE90001, 0x7FFFFFFFBF0001, 0x7FFFFFFFBD0001, 0x7FFFFFFFBA0001, 0x7FFFFFFFAA0001,
            0x7FFFFFFFA50001],
}

_DEFAULT_COEFF_256: Dict[int, List[int]] = {
    1024: [0x3001],
    2048: [0x1FFC0001],
    4096: [0x3FFFFFFFF040001],
    8192: [0x7FFFFEC001, 0x7FFFFB0001, 0xFFFFFDC001],
    16384: [0x7FFFFFFC8001, 0x7FFFFFF00001, 0x7FFFFFE70001, 0xFFFFFFFD8001, 0xFFFFFFFA0001],
    32768: [0xFFFFFFFF00001, 0x1FFFFFFFE30001, 0x1FFFFFFFD80001, 0x1FFFFFFFD10001, 0x1FFFFFFFC50001,
            0x1FFFFFFFBF0001, 0x1FFFFFFFB90001, 0x1FFFFFFFB60001, 0x1FFFFFFFA50001],
}


class CoeffModulus:
    """Factories for coefficient-modulus chains (modulus.h:412-506)."""

    @staticmethod
    def max_bit_count(poly_modulus_degree: int,
                      sec_level: SecurityLevel = SecurityLevel.tc128) -> int:
        return he_std_max_coeff_bits(poly_modulus_degree, sec_level)

    @staticmethod
    def bfv_default(poly_modulus_degree: int,
                    sec_level: SecurityLevel = SecurityLevel.tc128) -> List[Modulus]:
        table = {
            SecurityLevel.tc128: _DEFAULT_COEFF_128,
            SecurityLevel.tc192: _DEFAULT_COEFF_192,
            SecurityLevel.tc256: _DEFAULT_COEFF_256,
        }.get(sec_level)
        if table is None or poly_modulus_degree not in table:
            raise ValueError("no default coeff modulus for these parameters")
        return _mods(table[poly_modulus_degree])

    @staticmethod
    def create(poly_modulus_degree: int, bit_sizes: Sequence[int]) -> List[Modulus]:
        """Generate distinct NTT-friendly primes (≡ 1 mod 2N) with the given
        bit sizes, scanning downward per size class (modulus.cpp Create)."""
        if poly_modulus_degree > POLY_MOD_DEGREE_MAX or poly_modulus_degree < POLY_MOD_DEGREE_MIN \
                or numth.get_power_of_two(poly_modulus_degree) < 0:
            raise ValueError("poly_modulus_degree invalid")
        if len(bit_sizes) > COEFF_MOD_COUNT_MAX or len(bit_sizes) < 1:
            raise ValueError("bit_sizes invalid")
        if max(bit_sizes) > USER_MOD_BIT_COUNT_MAX or min(bit_sizes) < 2:
            raise ValueError("bit size out of [2, 60]")

        count_table: Dict[int, int] = {}
        for size in bit_sizes:
            count_table[size] = count_table.get(size, 0) + 1
        factor = 2 * poly_modulus_degree
        prime_table: Dict[int, List[int]] = {
            size: numth.get_primes(factor, size, cnt) for size, cnt in count_table.items()
        }
        result = []
        for size in bit_sizes:
            # reference pops from the BACK of the descending scan
            # (modulus.cpp:117 prime_table[size].back()) — ascending order
            result.append(Modulus(prime_table[size].pop()))
        return result


class PlainModulus:
    """Batching-capable plain-modulus factory (modulus.h:511-553)."""

    @staticmethod
    def batching(poly_modulus_degree: int, bit_size: int) -> Modulus:
        return CoeffModulus.create(poly_modulus_degree, [bit_size])[0]

    @staticmethod
    def batching_many(poly_modulus_degree: int, bit_sizes: Sequence[int]) -> List[Modulus]:
        return CoeffModulus.create(poly_modulus_degree, bit_sizes)
