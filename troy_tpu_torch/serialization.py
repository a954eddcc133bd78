"""Byte streams of ciphertexts, plaintexts, keys and encryption parameters.

The port of troy_tpu/serialization.py: the same formats, byte for byte
(reference: src/serialize.h:1-17, src/ciphertext_cuda.cu:16-140 save/load
with seed compression and saveTerms/loadTerms, app/LinearHelper.cuh:686-750).

Little-endian fixed headers and raw u64 words: TCT1 ciphertexts (header
"<BBHIQQdQ": level, NTT flag, size, limbs, n, seed, scale as f64,
correction factor), TPT1 plaintexts (level 0xFF for a mod-t plaintext),
TKY1 keys and TEP1 parameters. A seed-compressed ciphertext stores c0 and
its 64-bit seed, and loading regenerates c1 with rlwe.expand_seed, the
same threefry draw as the JAX package's, so a stream written by either
package loads in the other. save_terms writes only chosen coefficients of
c0 (marker 1 << 63 in the seed field) after leaving NTT form; load_terms
zero-fills the rest and transforms back.

Words cross to the host once per call: ``fetch_ciphertexts_host`` stacks a
list of ciphertexts, takes one inverse NTT over the stack when asked
(kernel A) and copies to the host once. Loads put their tensors on the
context's device, or on ``device`` where no context is given.
"""

from __future__ import annotations

import struct as _struct
from typing import List, Optional, Sequence

import numpy as np
import torch

from .context import HeContext
from .he_types import (Ciphertext, GaloisKeys, KSwitchKeys, Plaintext,
                       PublicKey, RelinKeys, SecretKey)
from .interop import DEFAULT_DEVICE, to_numpy, to_torch
from .ops import ntt as dntt

_MAGIC_CT = b"TCT1"
_MAGIC_PT = b"TPT1"
_MAGIC_KEY = b"TKY1"
_MAGIC_PARMS = b"TEP1"
_CT_HEAD = "<BBHIQQdQ"
_TERMS_MARKER = 1 << 63


def _u64s(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr, dtype="<u8").tobytes()


def _host(x) -> np.ndarray:
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def fetch_ciphertexts_host(cts: Sequence[Ciphertext], context: HeContext,
                           to_coeff: bool = False) -> List[np.ndarray]:
    """The words of same-shape ciphertexts in one device->host copy, in the
    coefficient domain if ``to_coeff`` (one inverse NTT over the stack;
    troy_tpu/serialization.py:45)."""
    if not cts:
        return []
    stacked = torch.stack([c.data for c in cts])
    if to_coeff and cts[0].is_ntt_form:
        cd = context.get_context_data(cts[0].level)
        stacked = dntt.rns_ntt_inverse(stacked, cd.ntt)
    host = to_numpy(stacked)
    return [host[i] for i in range(len(cts))]


# --------------------------------------------------------------------------
# ciphertexts
# --------------------------------------------------------------------------

def save_ciphertext(ct: Ciphertext,
                    host_data: Optional[np.ndarray] = None) -> bytes:
    """(ciphertext_cuda.cu:16-42). host_data: the ciphertext's words already
    on the host (fetch_ciphertexts_host), to save a copy per call."""
    if ct.seed != 0 and ct.size != 2:
        raise ValueError("seed-compressed ciphertext must have size 2")
    data = _host(ct.data) if host_data is None else host_data
    size, limbs, n = data.shape
    head = _MAGIC_CT + _struct.pack(
        _CT_HEAD, ct.level, int(ct.is_ntt_form), size, limbs, n, ct.seed,
        ct.scale, ct.correction_factor)
    return head + _u64s(data[0] if ct.seed != 0 else data)


def load_ciphertext(raw: bytes, context: HeContext) -> Ciphertext:
    """(ciphertext_cuda.cu:85-106); a seeded stream is expanded."""
    if raw[:4] != _MAGIC_CT:
        raise ValueError("not a ciphertext stream")
    level, is_ntt, size, limbs, n, seed, scale, correction = _struct.unpack(
        _CT_HEAD, raw[4:44])
    if seed != 0:
        data = np.zeros((2, limbs, n), dtype=np.uint64)
        data[0] = np.frombuffer(raw, dtype="<u8", count=limbs * n,
                                offset=44).reshape(limbs, n)
        ct = Ciphertext(data=to_torch(data, context.device), level=level,
                        is_ntt_form=bool(is_ntt), scale=scale,
                        correction_factor=correction, seed=seed)
        from . import rlwe
        return rlwe.expand_seed(ct, context.get_context_data(level))
    data = np.frombuffer(raw, dtype="<u8", count=size * limbs * n,
                         offset=44).reshape(size, limbs, n)
    return Ciphertext(data=to_torch(data, context.device), level=level,
                      is_ntt_form=bool(is_ntt), scale=scale,
                      correction_factor=correction)


def save_terms(ct: Ciphertext, context: HeContext, term_ids: Sequence[int],
               host_coeff_data: Optional[np.ndarray] = None) -> bytes:
    """The chosen coefficients of c0 and every other component whole
    (ciphertext_cuda.cu:44-83 saveTerms). host_coeff_data: the words already
    on the host in the coefficient domain (fetch_ciphertexts_host with
    to_coeff)."""
    if ct.seed != 0:
        raise ValueError("expand the seed before saving terms")
    if host_coeff_data is not None:
        data = host_coeff_data
    else:
        cd = context.get_context_data(ct.level)
        data = _host(dntt.rns_ntt_inverse(ct.data, cd.ntt)
                     if ct.is_ntt_form else ct.data)
    size, limbs, n = data.shape
    head = _MAGIC_CT + _struct.pack(
        _CT_HEAD, ct.level, int(ct.is_ntt_form), size, limbs, n,
        _TERMS_MARKER, ct.scale, ct.correction_factor)
    body = _u64s(data[0][:, np.asarray(term_ids, dtype=np.int64)])
    return head + body + _u64s(data[1:])


def load_terms(raw: bytes, context: HeContext,
               term_ids: Sequence[int]) -> Ciphertext:
    """(ciphertext_cuda.cu:108-140 loadTerms)"""
    if raw[:4] != _MAGIC_CT:
        raise ValueError("not a ciphertext stream")
    level, is_ntt, size, limbs, n, marker, scale, correction = _struct.unpack(
        _CT_HEAD, raw[4:44])
    if marker != _TERMS_MARKER:
        raise ValueError("stream was not saved with save_terms")
    ids = np.asarray(term_ids, dtype=np.int64)
    off = 44
    c0_sel = np.frombuffer(raw, dtype="<u8", count=limbs * len(ids),
                           offset=off).reshape(limbs, len(ids))
    off += 8 * limbs * len(ids)
    data = np.zeros((size, limbs, n), dtype=np.uint64)
    data[0][:, ids] = c0_sel
    data[1:] = np.frombuffer(raw, dtype="<u8", count=(size - 1) * limbs * n,
                             offset=off).reshape(size - 1, limbs, n)
    arr = to_torch(data, context.device)
    if is_ntt:
        arr = dntt.rns_ntt_forward(arr, context.get_context_data(level).ntt)
    return Ciphertext(data=arr, level=level, is_ntt_form=bool(is_ntt),
                      scale=scale, correction_factor=correction)


# --------------------------------------------------------------------------
# plaintexts
# --------------------------------------------------------------------------

def save_plaintext(pt: Plaintext) -> bytes:
    data = _host(pt.data)
    level = 0xFF if pt.level is None else pt.level
    limbs, n = (0, data.shape[0]) if data.ndim == 1 else data.shape
    head = _MAGIC_PT + _struct.pack("<BBIQd", level, int(pt.is_ntt_form),
                                    limbs, n, pt.scale)
    return head + _u64s(data)


def load_plaintext(raw: bytes, device=DEFAULT_DEVICE) -> Plaintext:
    if raw[:4] != _MAGIC_PT:
        raise ValueError("not a plaintext stream")
    level, is_ntt, limbs, n, scale = _struct.unpack("<BBIQd", raw[4:26])
    data = np.frombuffer(raw, dtype="<u8", count=(limbs if limbs else 1) * n,
                         offset=26).reshape((limbs, n) if limbs else (n,))
    return Plaintext(data=to_torch(data, device),
                     level=None if level == 0xFF else level,
                     is_ntt_form=bool(is_ntt), scale=scale)


# --------------------------------------------------------------------------
# keys
# --------------------------------------------------------------------------

def save_public_key(pk: PublicKey) -> bytes:
    data = _host(pk.data)
    head = _MAGIC_KEY + b"P" + _struct.pack("<IQQ", data.shape[1],
                                            data.shape[2], pk.seed)
    return head + _u64s(data)


def load_public_key(raw: bytes, device=DEFAULT_DEVICE) -> PublicKey:
    if raw[:5] != _MAGIC_KEY + b"P":
        raise ValueError("not a public key stream")
    limbs, n, seed = _struct.unpack("<IQQ", raw[5:25])
    data = np.frombuffer(raw, dtype="<u8", count=2 * limbs * n,
                         offset=25).reshape(2, limbs, n)
    return PublicKey(data=to_torch(data, device), seed=seed)


def save_secret_key(sk: SecretKey) -> bytes:
    data = _host(sk.data)
    return _MAGIC_KEY + b"S" + _struct.pack("<IQ", *data.shape) + _u64s(data)


def load_secret_key(raw: bytes, device=DEFAULT_DEVICE) -> SecretKey:
    if raw[:5] != _MAGIC_KEY + b"S":
        raise ValueError("not a secret key stream")
    limbs, n = _struct.unpack("<IQ", raw[5:17])
    data = np.frombuffer(raw, dtype="<u8", count=limbs * n,
                         offset=17).reshape(limbs, n)
    return SecretKey(data=to_torch(data, device))


def _save_kswitch(keys: KSwitchKeys, tag: bytes) -> bytes:
    out = [_MAGIC_KEY + tag + _struct.pack("<I", len(keys.keys))]
    for i in sorted(keys.keys):
        arr = _host(keys.keys[i])
        out.append(_struct.pack("<QIIIQ", i, *arr.shape))
        out.append(_u64s(arr))
    return b"".join(out)


def _load_kswitch(raw: bytes, tag: bytes, cls, device):
    if raw[:5] != _MAGIC_KEY + tag:
        raise ValueError("wrong key stream tag")
    count, = _struct.unpack("<I", raw[5:9])
    off = 9
    keys = {}
    for _ in range(count):
        idx, d0, d1, d2, d3 = _struct.unpack("<QIIIQ", raw[off:off + 28])
        off += 28
        cnt = d0 * d1 * d2 * d3
        arr = np.frombuffer(raw, dtype="<u8", count=cnt,
                            offset=off).reshape(d0, d1, d2, d3)
        off += 8 * cnt
        keys[int(idx)] = to_torch(arr, device)
    return cls(keys=keys)


def save_relin_keys(k: RelinKeys) -> bytes:
    return _save_kswitch(k, b"R")


def load_relin_keys(raw: bytes, device=DEFAULT_DEVICE) -> RelinKeys:
    return _load_kswitch(raw, b"R", RelinKeys, device)


def save_galois_keys(k: GaloisKeys) -> bytes:
    return _save_kswitch(k, b"G")


def load_galois_keys(raw: bytes, device=DEFAULT_DEVICE) -> GaloisKeys:
    return _load_kswitch(raw, b"G", GaloisKeys, device)


def save_kswitch_keys(k: KSwitchKeys) -> bytes:
    return _save_kswitch(k, b"K")


def load_kswitch_keys(raw: bytes, device=DEFAULT_DEVICE) -> KSwitchKeys:
    return _load_kswitch(raw, b"K", KSwitchKeys, device)


# --------------------------------------------------------------------------
# encryption parameters
# --------------------------------------------------------------------------

def save_parms(parms) -> bytes:
    """EncryptionParameters on the wire, so both parties of the app protocol
    agree on them (troy_tpu/serialization.py:286)."""
    head = _MAGIC_PARMS + _struct.pack(
        "<BQB", int(parms.scheme), parms.poly_modulus_degree,
        len(parms.coeff_modulus))
    body = _struct.pack(f"<{len(parms.coeff_modulus)}Q",
                        *[m.value for m in parms.coeff_modulus])
    return head + body + _struct.pack("<Q", parms.plain_modulus.value)


def load_parms(raw: bytes):
    from .modulus import Modulus
    from .params import EncryptionParameters, SchemeType
    if raw[:4] != _MAGIC_PARMS:
        raise ValueError("not an encryption-parameters stream")
    scheme, n, k = _struct.unpack("<BQB", raw[4:14])
    vals = _struct.unpack(f"<{k}Q", raw[14:14 + 8 * k])
    plain, = _struct.unpack("<Q", raw[14 + 8 * k:22 + 8 * k])
    return EncryptionParameters(
        scheme=SchemeType(scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(Modulus(v) for v in vals),
        plain_modulus=Modulus(plain))
