"""HE object model: plaintexts, ciphertexts and keys as dataclasses of tensors.

The port of troy_tpu/he_types.py (BFV, CKKS and BGV). Data lives in int64
tensors of u64 words on the context's device: ``Ciphertext.data`` is
(size, limbs, n); metadata (chain level, NTT flag, the CKKS scale, the BGV
correction factor, the seed of a seed-compressed c1) are plain fields.
Key-switching keys keep the dense (decomp, 2, key_limbs, n) layout of the
JAX package, which the key-switch inner product reads directly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch


class _Replaceable:
    """``replace(**changes)``: a copy with some fields changed, as on the
    JAX package's types (flax PyTreeNodes)."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class Plaintext(_Replaceable):
    """A plaintext polynomial: mod-t coefficients (n,) with level None, or
    mod-q NTT form (limbs, n) at a chain level (CKKS, with its scale)."""

    data: torch.Tensor
    level: Optional[int] = None
    is_ntt_form: bool = False
    scale: float = 1.0

    @property
    def coeff_count(self) -> int:
        return self.data.shape[-1]


@dataclass(frozen=True)
class Ciphertext:
    """An RLWE ciphertext: data[j] is the j-th polynomial, RNS limb-major.

    seed: the 64-bit seed that regenerates c1 of a symmetric ciphertext
    (``rlwe.expand_seed``); 0 means none. ``replace`` with new data drops
    it unless given, so every op that rewrites the ciphertext resets it."""

    data: torch.Tensor                # (size, limbs, n) u64 words
    level: int = 1
    is_ntt_form: bool = False
    scale: float = 1.0                # CKKS: the encoding scale
    correction_factor: int = 1        # BGV: the message is cf * m mod t
    seed: int = 0

    @property
    def size(self) -> int:
        return self.data.shape[0]

    @property
    def limbs(self) -> int:
        return self.data.shape[1]

    @property
    def n(self) -> int:
        return self.data.shape[2]

    def replace(self, **changes) -> "Ciphertext":
        if "data" in changes:
            changes.setdefault("seed", 0)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class LWECiphertext(_Replaceable):
    """An extracted LWE sample per RNS limb (ciphertext_cuda.cuh:270-310):
    it decrypts to <c1, s's coefficients> + c0."""

    c1: torch.Tensor                  # (limbs, n) u64 words
    c0: torch.Tensor                  # (limbs,)
    level: int = 1
    scale: float = 1.0
    correction_factor: int = 1


@dataclass(frozen=True)
class SecretKey(_Replaceable):
    """Secret key: NTT form over the key-level modulus, (key_limbs, n)."""

    data: torch.Tensor

    @property
    def limbs(self) -> int:
        return self.data.shape[0]


@dataclass(frozen=True)
class PublicKey(_Replaceable):
    """Public key: an encryption of zero at the key level, NTT form,
    (2, key_limbs, n); seed regenerates its c1 if not 0."""

    data: torch.Tensor
    seed: int = 0

    @property
    def as_ciphertext(self) -> Ciphertext:
        return Ciphertext(data=self.data, level=0, is_ntt_form=True)


@dataclass(frozen=True)
class KSwitchKeys(_Replaceable):
    """Key-switching keys: keys[idx] is (decomp, 2, key_limbs, n), NTT form;
    keys[idx][j, c] is the c-th component of the j-th decomposition
    ciphertext over the full key-level base."""

    keys: Dict[int, torch.Tensor]

    def has_key(self, idx: int) -> bool:
        return idx in self.keys


@dataclass(frozen=True)
class RelinKeys(KSwitchKeys):
    """Relinearization keys: keys[p] switches s^p -> s for p >= 2."""


@dataclass(frozen=True)
class GaloisKeys(KSwitchKeys):
    """Galois keys: keys[elt] switches s(x^elt) -> s (galoiskeys.h:36)."""
