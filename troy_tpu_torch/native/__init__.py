"""ctypes bindings of the port's native host runtime (src/troy_native.cpp).

The port of troy_tpu/native/__init__.py. The source is compiled at first
use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``build/troy_tpu_torch/`` beside the package (the kernels' build
directory), named by a hash of the source, and loaded with ctypes. This is
host code: it speeds up host keygen (the BLAKE2Xb stream), context
construction (the NTT tables and kernel J's factor matrices) and the CKKS
host decode. Every entry point returns None when the library cannot be
built or loaded, and its caller then runs the pure-Python version, which
gives the same words (tests/test_torch_native.py), so a machine without
``g++`` works, slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "troy_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" \
    / "troy_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_tried = False
build_seconds = 0.0
build_error = ""

_P, _U, _D = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_double
_SIGNATURES = {
    "xof_fill": ((ctypes.c_char_p, _U, _P, _U), None),
    "crt_compose_centered_double": (
        (_P, _U, _U, _P, _P, _P, _P, _P, _U, _D, _P), None),
    "ntt_tables_fill": ((_U, _U, _U, _U) + (_P,) * 4, None),
    "mxu_tables_fill": ((_U, _U, _U, _U, _U) + (_P,) * 8, None),
    "signed_digits_fill": ((_P, _U, _P), ctypes.c_int),
}


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtroy_native_{digest.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    global build_seconds
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        t0 = time.perf_counter()
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, path)
        finally:
            build_seconds = time.perf_counter() - t0
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None if that failed (the
    reason is in ``build_error``)."""
    global _lib, _tried, build_error
    if not _tried:
        _tried = True
        try:
            _lib = _build()
        except (OSError, subprocess.CalledProcessError) as exc:
            build_error = getattr(exc, "stderr", "") or str(exc)
            _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def xof_fill(seed: bytes, counter0: int, nbytes: int) -> Optional[bytes]:
    """nbytes of the buffered BLAKE2Xb stream from block counter0 on."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(nbytes, dtype=np.uint8)
    lib.xof_fill(seed, counter0, out.ctypes.data, nbytes)
    return out.tobytes()


def ntt_tables_fill(n: int, q: int, root: int, inv_root: int):
    """Bit-reversed root-power tables and their Shoup quotients, (powers,
    powers_shoup, inv_powers, inv_powers_shoup) u64 (n,); None if no
    library."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = [np.empty(n, dtype=np.uint64) for _ in range(4)]
    lib.ntt_tables_fill(n, q, root, inv_root, *(a.ctypes.data for a in arrs))
    return tuple(arrs)


def mxu_tables_fill(n: int, a: int, b: int, q: int, psi: int):
    """The 4-step factor matrices of n = a * b, (w1, tw, w2, v1, itw, v2,
    tw_shoup, itw_shoup) u64 row-major; None if no library."""
    lib = get_lib()
    if lib is None:
        return None
    shapes = [(a, a), (a, b), (b, b), (a, a), (a, b), (b, b), (a, b), (a, b)]
    arrs = [np.empty(s, dtype=np.uint64) for s in shapes]
    lib.mxu_tables_fill(n, a, b, q, psi, *(x.ctypes.data for x in arrs))
    return tuple(arrs)


def signed_digits_fill(mat: np.ndarray):
    """u64 array -> (8,) + mat.shape int8 signed radix-256 planes; None if
    no library. Raises on a value that needs a 9th digit, as the Python
    version asserts."""
    lib = get_lib()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, dtype=np.uint64)
    out = np.empty((8,) + mat.shape, dtype=np.int8)
    if lib.signed_digits_fill(mat.ctypes.data, mat.size, out.ctypes.data):
        raise ValueError("value exceeded the signed 8-digit range")
    return out


def crt_compose_centered_double(residues: np.ndarray, moduli, inv_punctured,
                                inv_punctured_shoup, punctured_words,
                                q_words, inv_scale: float
                                ) -> Optional[np.ndarray]:
    """(k, n) residues -> (n,) centred values as doubles, times
    inv_scale; None if no library."""
    lib = get_lib()
    if lib is None:
        return None
    residues = np.ascontiguousarray(residues, dtype=np.uint64)
    k, n = residues.shape
    arrays = [np.ascontiguousarray(a, dtype=np.uint64) for a in
              (moduli, inv_punctured, inv_punctured_shoup, punctured_words,
               q_words)]
    moduli, invp, invps, pw, qw = arrays
    out = np.empty(n, dtype=np.float64)
    lib.crt_compose_centered_double(
        residues.ctypes.data, k, n, moduli.ctypes.data, invp.ctypes.data,
        invps.ctypes.data, pw.ctypes.data, qw.ctypes.data, qw.shape[0],
        ctypes.c_double(inv_scale), out.ctypes.data)
    return out
