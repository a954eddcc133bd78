"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, kept under
``build/troy_tpu_torch/`` beside the package and named by a hash of the
sources, then loaded with ``ctypes``. Nothing here runs at import: the CPU
tests import every module on machines with no ``nvcc`` and no card.

Every C entry point launches on the caller's stream, allocates nothing and
returns ``cudaGetLastError()``; ``launch`` raises when that is not 0 and
counts the launch. The counts show which kernels a run went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "troy_tpu_torch"
SOURCES = ("ntt.cu", "dyadic_mac.cu", "base_convert.cu", "rns_elementwise.cu")
HEADERS = ("u64.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: (argtypes) of each entry point; all return int.
_SIGNATURES = {
    "troy_ntt": (_P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    "troy_dyadic_mac": (_P, _P, _P, _I, _L, _L, _I, _I, _P, _P, _P, _P),
    "troy_base_convert": (_P, _P, _L, _I, _I, _I, _P, _P),
    "troy_rns_elementwise": (_P, _P, _P, _I, _L, _I, _I, _P, _P, _P, _P),
}

# The kernel each entry point belongs to (A-D of the port's kernel list).
KERNELS = {
    "troy_ntt": "A_ntt",
    "troy_dyadic_mac": "B_dyadic_mac",
    "troy_base_convert": "C_base_convert",
    "troy_rns_elementwise": "D_rns_elementwise",
}

_launches: Dict[str, int] = {name: 0 for name in KERNELS.values()}
_lib: Optional[ctypes.CDLL] = None
build_log = ""
build_seconds = 0.0


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in HEADERS + SOURCES:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtroy_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of these sources exists."""
    global build_log, build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on a CUDA device, False if every one lies
    on the CPU (where the plain version runs); raises otherwise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors on devices {sorted(str(t.device) for t in tensors)}: "
                     "expected all on the CPU or all on one CUDA device")


def check_operand(t: torch.Tensor, name: str) -> None:
    """What every kernel takes: contiguous int64 (u64 words) on CUDA."""
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 u64 words, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


def launch(entry: str, *args) -> None:
    """Call one C entry point on the current stream and count the launch.
    Tensors in ``args`` pass as their data pointers, None as NULL."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    stream = torch.cuda.current_stream(device).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    status = getattr(library(), entry)(*c_args, stream)
    if status != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {status}")
    _launches[KERNELS[entry]] += 1
