"""Hex-poly strings: SEAL's human-readable polynomial notation.

The port's own copy of troy_tpu/hexpoly.py (reference: src/plaintext.h:
168-239 hex-string constructor, src/plaintext.cpp to_string /
util::polyToHexString): coefficients in uppercase hex, highest degree
first, zero terms skipped, e.g. ``"3Fx^3 + 2x^1 + 1"``; the zero
polynomial prints as ``"0"``. The reference's scheme tests drive
encrypt/evaluate/decrypt round trips through these strings.
"""

from __future__ import annotations

import re
from typing import Sequence, Union

import numpy as np
import torch

from .he_types import Plaintext
from .interop import DEFAULT_DEVICE, to_numpy, to_torch

_TERM = re.compile(r"^([0-9A-Fa-f]+)(?:x\^([0-9]+)|x)?$")


def poly_to_hex_string(coeffs: Union[Sequence[int], np.ndarray]) -> str:
    """Coefficient array (index = degree) -> hex-poly string."""
    arr = np.asarray(coeffs, dtype=np.uint64)
    terms = []
    for deg in range(arr.shape[0] - 1, -1, -1):
        c = int(arr[deg])
        if c == 0:
            continue
        terms.append(f"{c:X}" if deg == 0 else f"{c:X}x^{deg}")
    return " + ".join(terms) if terms else "0"


def hex_string_to_poly(s: str, coeff_count: int = 0) -> np.ndarray:
    """Hex-poly string -> uint64 coefficients (length max degree + 1, or
    coeff_count if larger); repeated degrees add mod 2^64."""
    s = s.strip()
    if not s:
        raise ValueError("empty hex-poly string")
    pairs = []
    for part in s.split("+"):
        term = part.replace(" ", "").strip()
        m = _TERM.match(term)
        if not m:
            raise ValueError(f"malformed hex-poly term: {part.strip()!r}")
        if m.group(2) is not None:
            deg = int(m.group(2))
        else:
            deg = 1 if term.lower().endswith("x") else 0
        pairs.append((deg, int(m.group(1), 16)))
    length = max(max(d for d, _ in pairs) + 1, coeff_count, 1)
    out = np.zeros(length, dtype=np.uint64)
    for deg, coeff in pairs:
        out[deg] = (int(out[deg]) + coeff) & 0xFFFFFFFFFFFFFFFF
    return out


def plaintext_to_string(pt: Plaintext) -> str:
    """A coefficient-form plaintext -> hex-poly string (plaintext.h:491)."""
    if pt.is_ntt_form:
        raise ValueError("cannot stringify an NTT-form plaintext")
    data = pt.data
    return poly_to_hex_string(to_numpy(data) if isinstance(data, torch.Tensor)
                              else data)


def plaintext_from_string(s: str, coeff_count: int = 0,
                          device=DEFAULT_DEVICE) -> Plaintext:
    """Hex-poly string -> coefficient-form Plaintext on ``device``."""
    return Plaintext(data=to_torch(hex_string_to_poly(s, coeff_count),
                                   device))
