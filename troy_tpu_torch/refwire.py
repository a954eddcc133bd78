"""troy's raw-struct wire format: byte interop with the reference library.

The port of troy_tpu/refwire.py. troy's live serialization is the raw
``save``/``load`` of its CUDA classes (reference: src/serialize.h:1-17
savet/loadt; src/ciphertext_cuda.cu:16-155 save/saveTerms/load/loadTerms;
src/plaintext_cuda.cu:7-27; src/kswitchkeys_cuda.cuh:330-354;
src/publickey_cuda.cuh:252-257 and src/secretkey_cuda.cuh:292-297, which
delegate to the ciphertext and the plaintext). Streams troy writes load
here, and the bytes written here are the ones troy writes for the same
object, so a party running the port can join a protocol whose peer runs
troy or its ``pytroy`` binder.

Layout (little-endian, no padding):
  * ParmsID: 32 bytes, blake2b-256 over the u64 words [scheme, n,
    q_0..q_{k-1}, t] (encryptionparams.cpp:118-146), which differs from
    the port's own ParmsID (params.py hashes a length word too):
    ``ref_parms_id``. Loads map it to a chain level of the context.
  * bool 1 byte, size_t and u64 8 bytes, double 8 bytes (IEEE).
  * Ciphertext: parms_id, is_ntt_form, size, n, k, scale,
    correction_factor, seed, terms = false, data_size, data[size k n]. A
    seed-compressed ciphertext is expanded first (kernel I through
    ``rlwe.expand_seed``) and written with seed 0: troy's own load refuses
    seeded streams (ciphertext_cuda.cu:104).
  * saveTerms: the same header with terms = true and seed 0, then for each
    term id the k residues of c0, then data_size = (size - 1) k n and the
    other components, all in the coefficient domain (troy leaves NTT form
    first and loadTerms returns to it, ciphertext_cuda.cu:50-57, 140-147):
    the transforms run on kernel A or J (ops/ntt.py).
  * Plaintext: parms_id (zero for a mod-t coefficient plaintext),
    coeff_count, scale, data_size, data.
  * KSwitchKeys: the key level's parms_id, the outer count, then per slot
    the inner count and that many public-key (ciphertext) streams; relin
    slot = key power - 2, Galois slot = (elt - 1) >> 1, an empty slot a
    count of 0.
"""

from __future__ import annotations

import hashlib
import struct as _struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .context import HeContext
from .he_types import (Ciphertext, GaloisKeys, Plaintext, PublicKey,
                       RelinKeys, SecretKey)
from .interop import to_numpy, to_torch
from .ops import ntt as dntt

REF_PARMS_ID_ZERO = b"\x00" * 32
_CT_HEAD = "<?QQQdQQ?"
_CT_HEAD_LEN = 32 + _struct.calcsize(_CT_HEAD)      # 82 bytes


def ref_parms_id(parms) -> bytes:
    """troy's ParmsID of a parameter set (encryptionparams.cpp:118-146)."""
    words = [int(parms.scheme), parms.poly_modulus_degree,
             *parms.coeff_values, int(parms.plain_modulus)]
    return hashlib.blake2b(_struct.pack(f"<{len(words)}Q", *words),
                           digest_size=32).digest()


def _level_of(pid: bytes, context: HeContext) -> int:
    for cd in context.chain:
        if ref_parms_id(cd.parms) == pid:
            return cd.chain_index
    raise ValueError("stream's parms_id matches no chain level")


def _u64s(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr, dtype="<u8").tobytes()


def _words(raw: bytes, count: int, offset: int, shape) -> np.ndarray:
    return np.frombuffer(raw, dtype="<u8", count=count,
                         offset=offset).reshape(shape)


def _ct_header(pid: bytes, is_ntt: bool, size: int, n: int, k: int,
               scale: float, correction: int, terms: bool) -> bytes:
    return pid + _struct.pack(_CT_HEAD, is_ntt, size, n, k, scale,
                              correction, 0, terms)


def _parse_ct_header(raw: bytes, off: int = 0):
    """(parms_id, is_ntt, size, n, k, scale, correction, seed, terms,
    offset past the header)."""
    fields = _struct.unpack_from(_CT_HEAD, raw, off + 32)
    return (raw[off:off + 32], *fields, off + _CT_HEAD_LEN)


# --------------------------------------------------------------------------
# ciphertexts
# --------------------------------------------------------------------------

def save_ciphertext_ref(ct: Ciphertext, context: HeContext) -> bytes:
    """CiphertextCuda::save (ciphertext_cuda.cu:16-42); a seed-compressed
    ciphertext is expanded first."""
    cd = context.get_context_data(ct.level)
    if ct.seed != 0:
        from . import rlwe
        ct = rlwe.expand_seed(ct, cd)
    data = to_numpy(ct.data)
    size, k, n = data.shape
    head = _ct_header(ref_parms_id(cd.parms), ct.is_ntt_form, size, n, k,
                      ct.scale, ct.correction_factor, False)
    return head + _struct.pack("<Q", size * k * n) + _u64s(data)


def load_ciphertext_ref(raw: bytes, context: HeContext) -> Ciphertext:
    """CiphertextCuda::load (ciphertext_cuda.cu:85-106)."""
    pid, is_ntt, size, n, k, scale, correction, seed, terms, off = \
        _parse_ct_header(raw)
    if terms:
        raise ValueError("stream was saved with saveTerms; use "
                         "load_terms_ref with the term ids")
    if seed != 0:
        raise ValueError("troy-format seeded streams are not loadable "
                         "(ciphertext_cuda.cu:104 refuses them too)")
    level = _level_of(pid, context)
    data_size, = _struct.unpack_from("<Q", raw, off)
    if data_size != size * k * n:
        raise ValueError("data size mismatch")
    data = _words(raw, data_size, off + 8, (size, k, n))
    return Ciphertext(data=to_torch(data, context.device), level=level,
                      is_ntt_form=bool(is_ntt), scale=scale,
                      correction_factor=correction)


def save_terms_ref(ct: Ciphertext, context: HeContext,
                   term_ids: Sequence[int]) -> bytes:
    """CiphertextCuda::saveTerms (ciphertext_cuda.cu:44-83): the chosen c0
    coefficients with all k residues each, then the other components
    whole, in the coefficient domain."""
    if ct.seed != 0:
        raise ValueError("expand the seed before saving terms")
    cd = context.get_context_data(ct.level)
    data = to_numpy(dntt.rns_ntt_inverse(ct.data, cd.ntt)
                    if ct.is_ntt_form else ct.data)
    size, k, n = data.shape
    head = _ct_header(ref_parms_id(cd.parms), ct.is_ntt_form, size, n, k,
                      ct.scale, ct.correction_factor, True)
    ids = np.asarray(term_ids, dtype=np.int64)
    return (head + _u64s(data[0][:, ids].T)
            + _struct.pack("<Q", (size - 1) * k * n) + _u64s(data[1:]))


def load_terms_ref(raw: bytes, context: HeContext,
                   term_ids: Sequence[int]) -> Ciphertext:
    """CiphertextCuda::loadTerms (ciphertext_cuda.cu:108-155): the other
    coefficients of c0 are zero."""
    pid, is_ntt, size, n, k, scale, correction, seed, terms, off = \
        _parse_ct_header(raw)
    if not terms:
        raise ValueError("stream was not saved with saveTerms")
    if seed != 0:
        raise ValueError("termed streams cannot be seeded")
    level = _level_of(pid, context)
    ids = np.asarray(term_ids, dtype=np.int64)
    sel = _words(raw, len(ids) * k, off, (len(ids), k))
    off += 8 * len(ids) * k
    data_size, = _struct.unpack_from("<Q", raw, off)
    if data_size != (size - 1) * k * n:
        raise ValueError("data size mismatch")
    data = np.zeros((size, k, n), dtype=np.uint64)
    data[0][:, ids] = sel.T
    data[1:] = _words(raw, data_size, off + 8, (size - 1, k, n))
    arr = to_torch(data, context.device)
    if is_ntt:
        arr = dntt.rns_ntt_forward(arr, context.get_context_data(level).ntt)
    return Ciphertext(data=arr, level=level, is_ntt_form=bool(is_ntt),
                      scale=scale, correction_factor=correction)


# --------------------------------------------------------------------------
# plaintexts and keys
# --------------------------------------------------------------------------

def save_plaintext_ref(pt: Plaintext, context: HeContext) -> bytes:
    """PlaintextCuda::save (plaintext_cuda.cu:7-15)."""
    data = to_numpy(pt.data)
    if pt.is_ntt_form:
        if pt.level is None:
            raise ValueError("NTT-form plaintext needs a level")
        pid = ref_parms_id(context.get_context_data(pt.level).parms)
    else:
        pid = REF_PARMS_ID_ZERO
    count = data.size if pt.is_ntt_form else data.shape[-1]
    return (pid + _struct.pack("<QdQ", count, pt.scale, data.size)
            + _u64s(data))


def load_plaintext_ref(raw: bytes, context: HeContext) -> Plaintext:
    """PlaintextCuda::load (plaintext_cuda.cu:17-27). troy allows a mod-t
    plaintext shorter than n (a trimmed constant); every op here takes n
    coefficients, so it is zero-padded (saving it again writes the same
    polynomial with coeff_count n)."""
    pid = raw[:32]
    _count, scale, data_size = _struct.unpack_from("<QdQ", raw, 32)
    flat = _words(raw, data_size, 56, (data_size,))
    if pid == REF_PARMS_ID_ZERO:
        n = context.n
        if flat.size > n:
            raise ValueError("plaintext longer than n")
        padded = np.zeros(n, dtype=np.uint64)
        padded[:flat.size] = flat
        return Plaintext(data=to_torch(padded, context.device), level=None,
                         is_ntt_form=False, scale=scale)
    level = _level_of(pid, context)
    k = context.get_context_data(level).limbs
    return Plaintext(data=to_torch(flat.reshape(k, data_size // k),
                                   context.device),
                     level=level, is_ntt_form=True, scale=scale)


def save_secret_key_ref(sk: SecretKey, context: HeContext) -> bytes:
    """SecretKeyCuda::save: the key's plaintext, NTT form at the key level
    (secretkey_cuda.cuh:292-294)."""
    return save_plaintext_ref(Plaintext(data=sk.data, level=0,
                                        is_ntt_form=True), context)


def load_secret_key_ref(raw: bytes, context: HeContext) -> SecretKey:
    pt = load_plaintext_ref(raw, context)
    if not pt.is_ntt_form or pt.level != 0:
        raise ValueError("not a key-level NTT-form secret key stream")
    return SecretKey(data=pt.data)


def save_public_key_ref(pk: PublicKey, context: HeContext) -> bytes:
    """PublicKeyCuda::save: the key's ciphertext, size 2, NTT form at the
    key level (publickey_cuda.cuh:252-254)."""
    return save_ciphertext_ref(Ciphertext(data=pk.data, level=0,
                                          is_ntt_form=True, seed=pk.seed),
                               context)


def load_public_key_ref(raw: bytes, context: HeContext) -> PublicKey:
    ct = load_ciphertext_ref(raw, context)
    if not ct.is_ntt_form or ct.level != 0:
        raise ValueError("not a key-level NTT-form public key stream")
    return PublicKey(data=ct.data)


def _save_kswitch_ref(slots: List[Optional[torch.Tensor]],
                      context: HeContext) -> bytes:
    """KSwitchKeysCuda::save (kswitchkeys_cuda.cuh:330-339): each key row
    a public-key stream (size 2, NTT form, key level); one readback per
    key."""
    pid = ref_parms_id(context.key_context_data.parms)
    out = [pid, _struct.pack("<Q", len(slots))]
    for key in slots:
        if key is None:
            out.append(_struct.pack("<Q", 0))
            continue
        words = to_numpy(key)                   # (decomp, 2, k, n)
        decomp, size, k, n = words.shape
        head = (_ct_header(pid, True, size, n, k, 1.0, 1, False)
                + _struct.pack("<Q", size * k * n))
        out.append(_struct.pack("<Q", decomp))
        out.extend(head + _u64s(row) for row in words)
    return b"".join(out)


def _load_kswitch_ref(raw: bytes, context: HeContext
                      ) -> Tuple[List[Optional[torch.Tensor]], int]:
    if raw[:32] != ref_parms_id(context.key_context_data.parms):
        raise ValueError("key stream's parms_id is not this context's key "
                         "level")
    outer, = _struct.unpack_from("<Q", raw, 32)
    off = 40
    slots: List[Optional[torch.Tensor]] = []
    for _ in range(outer):
        inner, = _struct.unpack_from("<Q", raw, off)
        off += 8
        if inner == 0:
            slots.append(None)
            continue
        rows = []
        for _ in range(inner):
            (_pid, _ntt, size, n, k, _scale, _cf, _seed, _terms,
             hoff) = _parse_ct_header(raw, off)
            data_size, = _struct.unpack_from("<Q", raw, hoff)
            rows.append(_words(raw, data_size, hoff + 8, (size, k, n)))
            off = hoff + 8 + 8 * data_size
        slots.append(to_torch(np.stack(rows), context.device))
    return slots, off


def save_relin_keys_ref(rk: RelinKeys, context: HeContext) -> bytes:
    """Slot of key power p: p - 2 (kswitchkeys.h getIndex)."""
    slots: List[Optional[torch.Tensor]] = [None] * (max(rk.keys) - 1)
    for p, key in rk.keys.items():
        slots[p - 2] = key
    return _save_kswitch_ref(slots, context)


def load_relin_keys_ref(raw: bytes, context: HeContext) -> RelinKeys:
    slots, _ = _load_kswitch_ref(raw, context)
    return RelinKeys(keys={i + 2: key for i, key in enumerate(slots)
                           if key is not None})


def save_galois_keys_ref(gk: GaloisKeys, context: HeContext) -> bytes:
    """Slot of Galois element e: (e - 1) >> 1."""
    slots: List[Optional[torch.Tensor]] = [None] * (
        ((max(gk.keys) - 1) >> 1) + 1)
    for e, key in gk.keys.items():
        slots[(e - 1) >> 1] = key
    return _save_kswitch_ref(slots, context)


def load_galois_keys_ref(raw: bytes, context: HeContext) -> GaloisKeys:
    slots, _ = _load_kswitch_ref(raw, context)
    return GaloisKeys(keys={2 * i + 1: key for i, key in enumerate(slots)
                            if key is not None})
