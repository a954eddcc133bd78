"""Encryption parameters and ParmsID.

Semantics-compatible with the reference's parameter layer
(reference: src/encryptionparams.h:18-505, src/encryptionparams.cpp:118-146):
a scheme tag, poly_modulus_degree N, a coefficient-modulus chain, and (for
BFV/BGV) a plain modulus, identified by a blake2b-256 hash over all of them.

Parameters are frozen and hashable, so per-level tables can be keyed by
them.
"""

from __future__ import annotations

import enum
import hashlib
import struct as _struct
from dataclasses import dataclass, field
from typing import Tuple

from .modulus import (
    Modulus, SecurityLevel, he_std_max_coeff_bits,
    COEFF_MOD_COUNT_MAX, POLY_MOD_DEGREE_MAX, POLY_MOD_DEGREE_MIN,
    PLAIN_MOD_BIT_COUNT_MAX,
)
from .utils import numth


class SchemeType(enum.IntEnum):
    """Scheme tags (encryptionparams.h:18-24)."""
    none = 0
    bfv = 1
    ckks = 2
    bgv = 3


ParmsID = bytes  # 32-byte blake2b-256 digest

PARMS_ID_ZERO: ParmsID = b"\x00" * 32


def _hash_params(scheme: int, n: int, coeff_values: Tuple[int, ...],
                 plain_value: int) -> ParmsID:
    """blake2b-256 over the parameter words (encryptionparams.cpp:118-146
    analogue: a fixed little-endian serialization of every parameter)."""
    h = hashlib.blake2b(digest_size=32)
    h.update(_struct.pack("<QQ", scheme, n))
    h.update(_struct.pack("<Q", len(coeff_values)))
    for v in coeff_values:
        h.update(_struct.pack("<Q", v))
    h.update(_struct.pack("<Q", plain_value))
    return h.digest()


@dataclass(frozen=True)
class EncryptionParameters:
    """Immutable parameter set (encryptionparams.h:79-505)."""

    scheme: SchemeType
    poly_modulus_degree: int
    coeff_modulus: Tuple[Modulus, ...]
    plain_modulus: Modulus = Modulus(0)

    def __post_init__(self):
        # normalize numpy integers (loaded configs) to Python ints: the
        # host toolchain relies on int methods (bit_length) and exact
        # big-int arithmetic
        object.__setattr__(self, "poly_modulus_degree",
                           int(self.poly_modulus_degree))
        if not isinstance(self.coeff_modulus, tuple):
            object.__setattr__(self, "coeff_modulus", tuple(self.coeff_modulus))
        if not isinstance(self.plain_modulus, Modulus):
            object.__setattr__(self, "plain_modulus", Modulus(int(self.plain_modulus)))
        if self.scheme == SchemeType.ckks and not self.plain_modulus.is_zero():
            raise ValueError("CKKS does not use a plain modulus")

    @property
    def coeff_values(self) -> Tuple[int, ...]:
        return tuple(int(m) for m in self.coeff_modulus)

    @property
    def parms_id(self) -> ParmsID:
        return _hash_params(int(self.scheme), self.poly_modulus_degree,
                            self.coeff_values, int(self.plain_modulus))

    def drop_last(self) -> "EncryptionParameters":
        """Parameters one modulus-switch level down."""
        return EncryptionParameters(
            scheme=self.scheme,
            poly_modulus_degree=self.poly_modulus_degree,
            coeff_modulus=self.coeff_modulus[:-1],
            plain_modulus=self.plain_modulus,
        )

    def __hash__(self):
        return hash((self.scheme, self.poly_modulus_degree,
                     self.coeff_values, int(self.plain_modulus)))


@dataclass(frozen=True)
class EncryptionParameterQualifiers:
    """Validation outcome for a parameter set (context.h:22-199)."""

    parameters_set: bool = False
    error_message: str = ""
    using_fft: bool = False
    using_ntt: bool = False
    using_batching: bool = False
    using_fast_plain_lift: bool = False
    using_descending_modulus_chain: bool = False
    sec_level: SecurityLevel = SecurityLevel.none


def validate(parms: EncryptionParameters,
             sec_level: SecurityLevel = SecurityLevel.tc128
             ) -> EncryptionParameterQualifiers:
    """Check a parameter set (context.cpp validate analogue). Returns
    qualifiers; parameters_set=False carries a human-readable reason."""
    def bad(msg):
        return EncryptionParameterQualifiers(False, msg)

    if parms.scheme == SchemeType.none:
        return bad("scheme unset")
    n = parms.poly_modulus_degree
    if n < POLY_MOD_DEGREE_MIN or n > POLY_MOD_DEGREE_MAX:
        return bad("poly_modulus_degree out of range")
    if numth.get_power_of_two(n) < 0:
        return bad("poly_modulus_degree must be a power of two")
    cm = parms.coeff_modulus
    if not (1 <= len(cm) <= COEFF_MOD_COUNT_MAX):
        return bad("coeff_modulus size out of range")
    values = parms.coeff_values
    for i, v in enumerate(values):
        for j in range(i + 1, len(values)):
            if not numth.are_coprime(v, values[j]):
                return bad("coeff_modulus must be pairwise coprime")
    total_bits = 1
    p = 1
    for v in values:
        p *= v
    total_bits = p.bit_length()
    if total_bits > he_std_max_coeff_bits(n, sec_level):
        return bad("coeff_modulus too large for security level")

    t = int(parms.plain_modulus)
    using_batching = False
    using_fast_plain_lift = False
    if parms.scheme in (SchemeType.bfv, SchemeType.bgv):
        if t == 0:
            return bad("plain_modulus unset")
        if parms.plain_modulus.bit_count > PLAIN_MOD_BIT_COUNT_MAX:
            return bad("plain_modulus too large")
        if any(t % v == 0 or v % t == 0 for v in values) and any(
                numth.gcd(t, v) != 1 for v in values):
            return bad("plain_modulus must be coprime to coeff_modulus")
        if t % (2 * n) == 1:
            using_batching = True
        using_fast_plain_lift = all(v > t for v in values)
    elif parms.scheme == SchemeType.ckks:
        if t != 0:
            return bad("CKKS must not set plain_modulus")

    # every coeff prime must support the 2N-th root NTT
    for v in values:
        if v % (2 * n) != 1 or not numth.is_prime(v):
            return bad("coeff_modulus primes must be NTT-friendly (1 mod 2N)")

    descending = all(values[i] > values[i + 1] for i in range(len(values) - 1))
    return EncryptionParameterQualifiers(
        parameters_set=True,
        error_message="",
        using_fft=True,
        using_ntt=True,
        using_batching=using_batching,
        using_fast_plain_lift=using_fast_plain_lift,
        using_descending_modulus_chain=descending,
        sec_level=sec_level,
    )
