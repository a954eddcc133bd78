"""HE object model: plaintexts, ciphertexts and keys as dataclasses of tensors.

The port of troy_tpu/he_types.py (BFV slice). Data lives in int64 tensors
of u64 words on the context's device: ``Ciphertext.data`` is
(size, limbs, n); metadata (chain level, NTT flag) are plain fields.
Key-switching keys keep the dense (decomp, 2, key_limbs, n) layout of the
JAX package, which the key-switch inner product reads directly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class Plaintext:
    """A plaintext polynomial: mod-t coefficients (n,) with level None, or
    mod-q NTT form (limbs, n) at a chain level."""

    data: torch.Tensor
    level: Optional[int] = None
    is_ntt_form: bool = False


@dataclass(frozen=True)
class Ciphertext:
    """An RLWE ciphertext: data[j] is the j-th polynomial, RNS limb-major."""

    data: torch.Tensor                # (size, limbs, n) u64 words
    level: int = 1
    is_ntt_form: bool = False

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
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class SecretKey:
    """Secret key: NTT form over the key-level modulus, (key_limbs, n)."""

    data: torch.Tensor

    @property
    def limbs(self) -> int:
        return self.data.shape[0]


@dataclass(frozen=True)
class KSwitchKeys:
    """Key-switching keys: keys[idx] is (decomp, 2, key_limbs, n), NTT form;
    keys[idx][j, c] is the c-th component of the j-th decomposition
    ciphertext over the full key-level base."""

    keys: Dict[int, torch.Tensor]


@dataclass(frozen=True)
class RelinKeys(KSwitchKeys):
    """Relinearization keys: keys[p] switches s^p -> s for p >= 2."""
