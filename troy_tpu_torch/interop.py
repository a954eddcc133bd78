"""The bridge between numpy u64 words and the port's tensors and objects.

Residues live in int64 tensors that hold u64 bit patterns; numpy keeps them
as uint64. ``to_torch`` and ``to_numpy`` reinterpret the bits (no value
changes), and the object builders below make the port's keys, ciphertexts
and plaintexts from numpy words plus their metadata, so state made
elsewhere (another implementation, a file, a test fixture) can be fed in,
and read back out as numpy words.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .he_types import Ciphertext, Plaintext, RelinKeys, SecretKey


def to_torch(words: np.ndarray, device=None) -> torch.Tensor:
    """u64 words (any integer array) -> int64 tensor of the same bits."""
    arr = np.array(words, dtype=np.uint64, copy=True)
    return torch.from_numpy(arr.view(np.int64)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of u64 words -> numpy uint64 array (a host copy)."""
    return t.detach().to("cpu").numpy().view(np.uint64).copy()


def secret_key(words: np.ndarray, device=None) -> SecretKey:
    """SecretKey from its (key_limbs, n) NTT-form words."""
    return SecretKey(data=to_torch(words, device))


def relin_keys(keys: Dict[int, np.ndarray], device=None) -> RelinKeys:
    """RelinKeys from {power: (decomp, 2, key_limbs, n) words}."""
    return RelinKeys(keys={int(p): to_torch(w, device)
                           for p, w in keys.items()})


def ciphertext(words: np.ndarray, level: int, is_ntt_form: bool,
               device=None) -> Ciphertext:
    """Ciphertext from (size, limbs, n) words at a chain level."""
    return Ciphertext(data=to_torch(words, device), level=int(level),
                      is_ntt_form=bool(is_ntt_form))


def plaintext(words: np.ndarray, device=None, level: Optional[int] = None,
              is_ntt_form: bool = False) -> Plaintext:
    """Plaintext from (n,) mod-t words (or (limbs, n) NTT-form words at a
    level)."""
    return Plaintext(data=to_torch(words, device), level=level,
                     is_ntt_form=is_ntt_form)


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
    """The numpy u64 words of a port object's data; for RelinKeys a dict
    {power: words}."""
    if isinstance(obj, RelinKeys):
        return {p: to_numpy(w) for p, w in obj.keys.items()}
    return to_numpy(obj.data)
