"""The bridge between numpy u64 words and the port's tensors and objects.

Residues live in int64 tensors that hold u64 bit patterns; numpy keeps them
as uint64. ``to_torch`` and ``to_numpy`` reinterpret the bits (no value
changes), and the object builders below make the port's keys, ciphertexts
and plaintexts from numpy words plus their metadata, so state made
elsewhere (another implementation, a file, a test fixture) can be fed in,
and read back out as numpy words. Tensors go to the card unless the caller
names another device, as ``HeContext`` does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .he_types import (Ciphertext, GaloisKeys, KSwitchKeys, LWECiphertext,
                       Plaintext, PublicKey, RelinKeys, SecretKey)

# The device of every entry point that is not told another.
DEFAULT_DEVICE = "cuda"


def to_torch(words: np.ndarray, device=DEFAULT_DEVICE) -> torch.Tensor:
    """u64 words (any integer array) -> int64 tensor of the same bits."""
    arr = np.array(words, dtype=np.uint64, copy=True)
    return torch.from_numpy(arr.view(np.int64)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of u64 words -> numpy uint64 array (a host copy)."""
    return t.detach().to("cpu").numpy().view(np.uint64).copy()


def secret_key(words: np.ndarray, device=DEFAULT_DEVICE) -> SecretKey:
    """SecretKey from its (key_limbs, n) NTT-form words."""
    return SecretKey(data=to_torch(words, device))


def public_key(words: np.ndarray, seed: int = 0,
               device=DEFAULT_DEVICE) -> PublicKey:
    """PublicKey from its (2, key_limbs, n) NTT-form words and the seed of
    its c1 (0 for none)."""
    return PublicKey(data=to_torch(words, device), seed=int(seed))


def relin_keys(keys: Dict[int, np.ndarray],
               device=DEFAULT_DEVICE) -> RelinKeys:
    """RelinKeys from {power: (decomp, 2, key_limbs, n) words}."""
    return RelinKeys(keys={int(p): to_torch(w, device)
                           for p, w in keys.items()})


def ciphertext(words: np.ndarray, level: int, is_ntt_form: bool,
               device=DEFAULT_DEVICE, scale: float = 1.0,
               correction_factor: int = 1) -> Ciphertext:
    """Ciphertext from (size, limbs, n) words at a chain level (CKKS: with
    its scale; BGV: with its correction factor)."""
    return Ciphertext(data=to_torch(words, device), level=int(level),
                      is_ntt_form=bool(is_ntt_form), scale=float(scale),
                      correction_factor=int(correction_factor))


def lwe_ciphertext(c1: np.ndarray, c0: np.ndarray, level: int,
                   device=DEFAULT_DEVICE, scale: float = 1.0,
                   correction_factor: int = 1) -> LWECiphertext:
    """LWECiphertext from its (limbs, n) c1 words and (limbs,) c0 words at a
    chain level (CKKS: with its scale; BGV: with its correction factor)."""
    return LWECiphertext(c1=to_torch(c1, device), c0=to_torch(c0, device),
                         level=int(level), scale=float(scale),
                         correction_factor=int(correction_factor))


def plaintext(words: np.ndarray, device=DEFAULT_DEVICE,
              level: Optional[int] = None,
              is_ntt_form: bool = False, scale: float = 1.0) -> Plaintext:
    """Plaintext from (n,) mod-t words (or (limbs, n) NTT-form words at a
    level, CKKS with its scale)."""
    return Plaintext(data=to_torch(words, device), level=level,
                     is_ntt_form=is_ntt_form, scale=float(scale))


def galois_keys(keys: Dict[int, np.ndarray],
                device=DEFAULT_DEVICE) -> GaloisKeys:
    """GaloisKeys from {Galois element: (decomp, 2, key_limbs, n) words}."""
    return GaloisKeys(keys={int(e): to_torch(w, device)
                            for e, w in keys.items()})


def shard_range(size: int, parts: int, index: int) -> range:
    """The run of an axis of ``size`` that part ``index`` of ``parts``
    holds, cut as GSPMD cuts a sharded axis: ceil(size / parts) items each,
    the last parts fewer or none."""
    step = -(-size // parts)
    return range(min(index * step, size), min((index + 1) * step, size))


def load_records(path) -> Dict[str, np.ndarray]:
    """Reference-vector records (the ``tests/data/ref_*.bin`` files): each is
    a text line 'name count' then count little-endian u64 words."""
    raw, data, pos = {}, Path(path).read_bytes(), 0
    while pos < len(data):
        nl = data.index(b"\n", pos)
        name, count = data[pos:nl].decode().rsplit(" ", 1)
        raw[name] = np.frombuffer(data, dtype="<u8", count=int(count),
                                  offset=nl + 1)
        pos = nl + 1 + int(count) * 8
    return raw


def words(obj):
    """The numpy u64 words of a port object's data (a ciphertext, plaintext,
    secret or public key); for switching keys (KSwitchKeys, RelinKeys,
    GaloisKeys) a dict {power or Galois element: words}; for an LWE sample
    the pair (c1 words, c0 words)."""
    if isinstance(obj, KSwitchKeys):
        return {p: to_numpy(w) for p, w in obj.keys.items()}
    if isinstance(obj, LWECiphertext):
        return to_numpy(obj.c1), to_numpy(obj.c0)
    return to_numpy(obj.data)
