"""Validity checks for HE objects against a context.

The port of troy_tpu/valcheck.py (reference: src/valcheck.h:31-256,
src/valcheck.cpp) on the port's tensors: three tiers, metadata (level and
shape bookkeeping), buffer (the tensors hold int64 u64 words) and data
(every residue below its prime; a device-to-host readback, so it belongs
at trust boundaries such as deserialization, not on the hot path).

``check_is_valid_for`` raises ``ValueError`` with the first failing reason;
the ``is_*`` predicates return bools, or raise with ``raise_on_fail``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .context import HeContext
from .he_types import (Ciphertext, GaloisKeys, KSwitchKeys, Plaintext,
                       PublicKey, SecretKey)
from .interop import to_numpy
from .params import SchemeType

HeObject = Union[Plaintext, Ciphertext, SecretKey, PublicKey, KSwitchKeys]

# ciphertext size bounds (reference: src/utils/defines.h SEAL_CIPHERTEXT_SIZE_*)
CIPHERTEXT_SIZE_MIN = 2
CIPHERTEXT_SIZE_MAX = 16


def _fail(ok: bool, raise_on_fail: bool, msg: str) -> bool:
    if not ok and raise_on_fail:
        raise ValueError(msg)
    return ok


def _shape(t) -> tuple:
    return tuple(t.shape)


def is_metadata_valid_for(obj: HeObject, context: HeContext,
                          raise_on_fail: bool = False) -> bool:
    """Level and shape consistency (valcheck.h isMetadataValidFor)."""
    def bad(msg):
        return _fail(False, raise_on_fail, msg)

    if isinstance(obj, Plaintext):
        n = context.n
        if obj.is_ntt_form:
            if obj.level is None:
                return bad("NTT plaintext has no level")
            if not 0 <= obj.level < len(context.chain):
                return bad("plaintext level out of range")
            cd = context.get_context_data(obj.level)
            if _shape(obj.data) != (cd.limbs, n):
                return bad(f"NTT plaintext shape {_shape(obj.data)} != "
                           f"({cd.limbs}, {n})")
        elif obj.data.dim() != 1 or obj.data.shape[0] > n:
            return bad(f"plaintext length {_shape(obj.data)} exceeds n={n}")
        return True
    if isinstance(obj, Ciphertext):
        if not 0 <= obj.level < len(context.chain):
            return bad("ciphertext level out of range")
        cd = context.get_context_data(obj.level)
        if obj.data.dim() != 3:
            return bad("ciphertext data must be 3-D")
        size, limbs, n = _shape(obj.data)
        if not CIPHERTEXT_SIZE_MIN <= size <= CIPHERTEXT_SIZE_MAX:
            return bad(f"ciphertext size {size} out of [2, 16]")
        if limbs != cd.limbs or n != cd.n:
            return bad(f"ciphertext shape {_shape(obj.data)} mismatches "
                       f"level {obj.level} ({cd.limbs} limbs, n={cd.n})")
        scheme = context.scheme
        if scheme == SchemeType.ckks and not obj.is_ntt_form:
            return bad("CKKS ciphertext must be in NTT form")
        if scheme == SchemeType.bfv and obj.is_ntt_form:
            return bad("BFV ciphertext must not be in NTT form")
        if scheme != SchemeType.ckks and obj.scale != 1.0:
            return bad("scale must be 1 outside CKKS")
        if scheme != SchemeType.bgv and obj.correction_factor != 1:
            return bad("correction factor must be 1 outside BGV")
        return True
    key_cd = context.key_context_data
    if isinstance(obj, SecretKey):
        if _shape(obj.data) != (key_cd.limbs, key_cd.n):
            return bad(f"secret key shape {_shape(obj.data)} != "
                       f"({key_cd.limbs}, {key_cd.n})")
        return True
    if isinstance(obj, PublicKey):
        if _shape(obj.data) != (2, key_cd.limbs, key_cd.n):
            return bad(f"public key shape {_shape(obj.data)} != "
                       f"(2, {key_cd.limbs}, {key_cd.n})")
        return True
    if isinstance(obj, KSwitchKeys):
        decomp = len(context.first_context_data.coeff_modulus)
        want = (decomp, 2, key_cd.limbs, key_cd.n)
        for idx, arr in obj.keys.items():
            if _shape(arr) != want:
                return bad(f"kswitch key {idx} shape {_shape(arr)} != "
                           f"{want}")
            # Galois elements are odd residues mod 2n (galois.h:68)
            if isinstance(obj, GaloisKeys) and (
                    idx % 2 == 0 or not 1 <= idx < 2 * context.n):
                return bad(f"invalid Galois element {idx}")
        return True
    return bad(f"unknown object type {type(obj)}")


def is_buffer_valid(obj: HeObject, raise_on_fail: bool = False) -> bool:
    """Backing-store validity (valcheck.h isBufferValid): every HE tensor
    holds u64 words as int64; shapes are the metadata tier's."""
    if isinstance(obj, (Plaintext, Ciphertext, SecretKey, PublicKey)):
        arrs = [obj.data]
    elif isinstance(obj, KSwitchKeys):
        arrs = list(obj.keys.values())
    else:
        return _fail(False, raise_on_fail, f"unknown object type {type(obj)}")
    for a in arrs:
        if not isinstance(a, torch.Tensor) or a.dtype != torch.int64:
            return _fail(False, raise_on_fail,
                         f"HE buffers must be int64 tensors of u64 words, "
                         f"got {getattr(a, 'dtype', type(a))}")
    return True


def _below(words: torch.Tensor, moduli, limb_axis: int) -> bool:
    """Every residue of limb i along ``limb_axis`` below moduli[i] (a
    buffer of another integer type compares by its values)."""
    arr = to_numpy(words) if words.dtype == torch.int64 \
        else words.cpu().numpy()
    q = np.array(moduli, dtype=np.uint64).reshape(
        (-1,) + (1,) * (arr.ndim - limb_axis - 1))
    return bool((arr < q).all())


def is_data_valid_for(obj: HeObject, context: HeContext,
                      raise_on_fail: bool = False) -> bool:
    """Coefficient bounds (valcheck.h isDataValidFor): every residue below
    its prime, a mod-t plaintext below t. Reads the words back."""
    key_cd = context.key_context_data
    if isinstance(obj, Plaintext):
        if obj.is_ntt_form:
            good = _below(obj.data, context.get_context_data(
                obj.level).coeff_values, 0)
        else:
            t = int(key_cd.plain_modulus)
            # CKKS coefficient plaintext: bounded by the key modulus
            good = t == 0 or bool((to_numpy(obj.data) < t).all())
        return _fail(good, raise_on_fail, "plaintext data out of bounds")
    if isinstance(obj, Ciphertext):
        good = _below(obj.data, context.get_context_data(
            obj.level).coeff_values, 1)
        return _fail(good, raise_on_fail, "ciphertext data out of bounds")
    if isinstance(obj, SecretKey):
        return _fail(_below(obj.data, key_cd.coeff_values, 0),
                     raise_on_fail, "secret key data out of bounds")
    if isinstance(obj, PublicKey):
        return _fail(_below(obj.data, key_cd.coeff_values, 1),
                     raise_on_fail, "public key data out of bounds")
    if isinstance(obj, KSwitchKeys):
        good = all(_below(arr, key_cd.coeff_values, 2)
                   for arr in obj.keys.values())
        return _fail(good, raise_on_fail, "kswitch key data out of bounds")
    return _fail(False, raise_on_fail, f"unknown object type {type(obj)}")


def is_valid_for(obj: HeObject, context: HeContext) -> bool:
    """Metadata, buffer and data (valcheck.h isValidFor)."""
    return (is_metadata_valid_for(obj, context) and is_buffer_valid(obj)
            and is_data_valid_for(obj, context))


def check_is_valid_for(obj: HeObject, context: HeContext) -> None:
    """Raise ValueError with the first failing reason."""
    is_metadata_valid_for(obj, context, raise_on_fail=True)
    is_buffer_valid(obj, raise_on_fail=True)
    is_data_valid_for(obj, context, raise_on_fail=True)
