"""Galois automorphism tooling — host-side permutation precompute.

Semantics-compatible with the reference's GaloisTool
(reference: src/utils/galois.h:16-118, src/utils/galois.cpp:17-177 and the
NTT-domain permutation tables of src/utils/galois_cuda.cu:139-208).

The automorphism x -> x^elt (elt odd, mod 2N) is, on device, a pure gather:
* coefficient domain: out[j] = sign[j] * in[src[j]] with a sign flip for
  indices that wrapped past x^N = -1;
* NTT domain: a signless permutation of the bit-reversed evaluation points.

Both index tables are computed here once per (n, elt) and cached as numpy
arrays; ops/galois.py keeps their device copies per (n, elt, device).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np

from . import numth

GENERATOR = 3  # the fixed generator g of the slot group (galois.h:107)


def get_elt_from_step(n: int, step: int) -> int:
    """Rotation step -> Galois element 3^step mod 2N (negative steps use the
    inverse orbit); step 0 means conjugation/row-swap elt = 2N-1
    (galois.cpp:95-123)."""
    m = 2 * n
    if step == 0:
        return m - 1
    pos = step > 0
    step = abs(step)
    if step >= n // 2:
        raise ValueError("step count too large")
    if not pos:
        step = n // 2 - step
    return pow(GENERATOR, step, m)


def get_elts_from_steps(n: int, steps) -> List[int]:
    return [get_elt_from_step(n, s) for s in steps]


def get_elts_all(n: int) -> List[int]:
    """Default key set: conjugation plus +-2^i steps (galois.cpp:125-150)."""
    m = 2 * n
    elts = [m - 1]
    step = 1
    while step <= n // 4:
        elts.append(get_elt_from_step(n, step))
        elts.append(get_elt_from_step(n, -step))
        step *= 2
    return elts


def _brv_table(log_n: int) -> np.ndarray:
    """Vectorized bit-reversal permutation of [0, 2^log_n)."""
    n = 1 << log_n
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        out = (out << 1) | ((idx >> b) & 1)
    return out


@lru_cache(maxsize=None)
def coeff_permutation(n: int, elt: int) -> Tuple[np.ndarray, np.ndarray]:
    """Coefficient-domain automorphism as an output gather:
    out[j] = in[src[j]] if keep_sign[j] else -in[src[j]]  (mod q).

    Derivation: input coeff i lands at raw index i*elt mod 2N; wrapping past
    N negates (x^N = -1). Inverted via elt^{-1} mod 2N so the device op is a
    single gather (galois.cpp applyGalois, re-indexed output-major)."""
    if elt % 2 == 0:
        raise ValueError("Galois element must be odd")
    m = 2 * n
    inv = numth.invert_mod(elt, m)
    i = (np.arange(n, dtype=np.int64) * inv) % m
    keep_sign = i < n
    src = np.where(keep_sign, i, i - n).astype(np.int32)
    src.setflags(write=False)
    keep_sign.setflags(write=False)
    return src, keep_sign


@lru_cache(maxsize=None)
def ntt_permutation(n: int, elt: int) -> np.ndarray:
    """NTT-domain automorphism table: out[i] = in[perm[i]] over the
    bit-reversed evaluation order (galois.cpp generateTableNtt:
    perm[i] = brv(((elt * (2*brv(i)+1)) mod 2N - 1) / 2))."""
    log_n = numth.get_power_of_two(n)
    m = 2 * n
    brv = _brv_table(log_n)
    index_raw = (elt * (2 * brv + 1)) % m
    perm = brv[(index_raw - 1) // 2].astype(np.int32)
    perm.setflags(write=False)
    return perm
