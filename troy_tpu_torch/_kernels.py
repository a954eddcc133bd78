"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, then linked into
one shared library with a plain C interface, kept under
``build/troy_tpu_torch/`` beside the package and named by a hash of the
sources, and loaded with ``ctypes``. Nothing here runs at import: the CPU
tests import every module on machines with no ``nvcc`` and no card.

Every C entry point launches on the caller's stream, allocates nothing and
returns ``cudaGetLastError()``; ``launch`` raises when that is not 0 and
counts the launch. The counts show which kernels a run went through.
There is no fallback: a failed build or launch raises.

A launch is on the host path of every kernel call, so it does only what a
call needs: the entry point's ctypes function is bound once (when the
library loads), the current stream is read as a raw integer
(``torch._C._cuda_getCurrentRawStream``, no ``Stream`` object), and the
wrapper names the device index instead of ``launch`` searching the
arguments for it.
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

from .utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "troy_tpu_torch"
SOURCES = ("ntt.cu", "dyadic_mac.cu", "base_convert.cu", "rns_elementwise.cu",
           "behz.cu", "keyswitch.cu", "plain_embed.cu", "galois.cu",
           "embedding.cu", "divide_round_ntt.cu", "exact_convert.cu",
           "sampling.cu", "negacyclic.cu", "tiles.cu", "ntt_mxu.cu",
           "sharding.cu")
HEADERS = ("u64.cuh", "butterfly.cuh", "divide_round.cuh", "decrypt.cuh",
           "plain_lift.cuh", "ckks_round.cuh", "plain_embed.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
_D = ctypes.c_double
# K' folded into A's forward (out, last, x, acc, comps, acc_comps, group,
# acc_groups, k, log_n, roots, roots_shoup, moduli, consts, stream)
_FUSED_DIVIDE = (_P, _P, _P, _P, _L, _I, _L, _L, _I, _I, _P, _P, _P, _P, _P)
# C signatures: (argtypes) of each entry point; all return int.
_SIGNATURES = {
    "troy_ntt": (_P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    "troy_ntt_forward_digits": (_P, _P, _L, _I, _I, _P, _P, _P, _P, _P),
    "troy_ntt_forward_lift": (_P, _P, _L, _I, _I, _P, _P, _P, _P, _U, _U, _U,
                              _P),
    "troy_ntt_forward_round": (_P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _I,
                               _D, _P),
    "troy_ntt_forward_round_stats": (_P, _P, _P, _L, _P, _P, _L, _I, _I, _P,
                                     _P, _P, _P, _I, _D, _P),
    "troy_ntt_inverse_pair_convolve": (_P, _P, _P, _L, _L, _I, _I, _I, _I, _P,
                                       _P, _P, _P, _P, _P, _P, _P),
    "troy_ntt_forward_rescale": _FUSED_DIVIDE,
    "troy_ntt_forward_keyswitch": _FUSED_DIVIDE,
    "troy_ntt_forward_bgv_mod_switch": _FUSED_DIVIDE,
    "troy_ntt_forward_bgv_keyswitch": _FUSED_DIVIDE,
    "troy_ntt_inverse_keyswitch": (_P, _P, _P, _P, _L, _I, _L, _L, _I, _I,
                                   _P, _P, _P, _P, _P, _P, _P),
    "troy_ntt_inverse_decrypt_bgv": (_P, _P, _P, _L, _I, _I, _P, _P, _P, _P,
                                     _U, _U, _P),
    "troy_ntt_inverse_decrypt_bfv": (_P, _P, _P, _L, _I, _I, _P, _P, _P, _P,
                                     _P, _P),
    "troy_ntt_blocks": (_L, _I, _I, _P),                # no launch: a query
    "troy_ntt_inverse_decrypt_plan": (_L, _I, _I, _I, _P),  # a query too
    "troy_dyadic_mac": (_P, _P, _P, _P, _I, _I, _L, _I, _I, _L, _L, _L, _L,
                        _L, _I, _L, _L, _L, _L, _P, _P, _P, _P),
    "troy_dyadic_convolve": (_P, _P, _P, _I, _L, _I, _I, _I, _I, _L, _L, _P,
                             _P, _P, _P),
    "troy_base_convert": (_P, _P, _L, _I, _I, _I, _P, _P),
    "troy_rns_elementwise": (_P, _L, _P, _P, _P, _L, _L, _P, _I, _L, _I, _I,
                             _P, _P, _P, _P, _P, _P),
    "troy_behz_lift": (_P, _P, _L, _I, _I, _I, _P, _I, _P),
    "troy_behz_tail": (_P, _P, _L, _I, _I, _I, _P, _I, _P),
    "troy_behz_decrypt_round": (_P, _P, _L, _I, _P, _I, _P),
    "troy_keyswitch_digits": (_P, _P, _L, _I, _I, _P, _P, _P),
    "troy_keyswitch_divide_round": (_P, _P, _P, _L, _I, _L, _L, _I, _I, _P,
                                    _P),
    "troy_mod_switch_divide_round": (_P, _P, _P, _L, _I, _L, _L, _I, _I, _P,
                                     _P),
    "troy_bgv_divide_coeff": (_P, _P, _P, _L, _I, _L, _L, _I, _I, _P, _P),
    "troy_rns_zero_embed": (_P, _L, _P, _P, _P, _L, _P, _I, _L, _I, _I, _P,
                            _P),
    "troy_bfv_plain_embed": (_P, _L, _P, _P, _L, _P, _L, _I, _I, _L, _I, _I,
                             _P, _P),
    "troy_galois_permute": (_P, _P, _P, _L, _I, _I, _P, _P),
    "troy_galois_permute_batched": (_P, _P, _P, _L, _I, _I, _P, _L, _I, _P),
    "troy_ckks_fft_encode": (_P, _P, _P, _P, _L, _P, _P, _P, _I, _I, _D, _P),
    "troy_ckks_fft_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "troy_ckks_round": (_P, _P, _P, _D, _I, _I, _P, _I, _P),
    "troy_ckks_round_stats": (_P, _P, _P, _P, _D, _I, _I, _P, _I, _P),
    "troy_ckks_fft_decode_stats": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _P),
    "troy_ckks_compose": (_P, _P, _I, _I, _I, _P, _D, _P),
    "troy_ckks_fft_geometry": (_I, _I, _P),             # no launch: a query
    "troy_rescale_ntt_temps": (_P, _P, _L, _I, _I, _P, _P),
    "troy_rescale_ntt_finish": (_P, _P, _P, _P, _L, _I, _L, _L, _I, _I, _P,
                               _P),
    "troy_keyswitch_ntt_temps": (_P, _P, _L, _I, _I, _P, _P),
    "troy_keyswitch_ntt_finish": (_P, _P, _P, _P, _L, _I, _L, _L, _I, _I, _P,
                                 _P),
    "troy_bgv_mod_switch_ntt_temps": (_P, _P, _L, _I, _I, _P, _P),
    "troy_bgv_mod_switch_ntt_finish": (_P, _P, _P, _P, _L, _I, _L, _L, _I,
                                       _I, _P, _P),
    "troy_bgv_keyswitch_ntt_temps": (_P, _P, _L, _I, _I, _P, _P),
    "troy_exact_convert": (_P, _P, _L, _I, _I, _P, _U, _U, _P),
    "troy_plain_lift": (_P, _P, _L, _I, _I, _U, _U, _U, _P, _P),
    "troy_sample_uniform_rns": (_P, _P, _U, _L, _I, _I, _P, _P, _P, _P),
    "troy_sample_cbd_rns": (_P, _P, _U, _L, _I, _I, _P, _P, _P, _P),
    "troy_sample_ternary_rns": (_P, _P, _U, _L, _I, _I, _P, _P),
    "troy_sample_zero_sym": (_P, _P, _P, _U, _P, _U, _L, _I, _I, _P, _P, _P,
                             _P, _P, _P),
    "troy_sample_zero_asym": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
    "troy_negacyclic_shift": (_P, _P, _P, _L, _L, _I, _I, _I, _P, _P),
    "troy_extract_lwe": (_P, _P, _P, _P, _L, _I, _I, _P, _P),
    "troy_assemble_lwe": (_P, _P, _P, _P, _L, _L, _I, _I, _P, _P, _P, _P),
    "troy_pack_fold_prepare": (_P, _P, _P, _L, _L, _I, _I, _P, _P),
    "troy_tile_contract": (_P, _P, _P, _L, _L, _L, _I, _I, _I, _P, _P, _P,
                           _P),
    "troy_tile_pair_convolve": (_P, _P, _P, _L, _L, _I, _I, _I, _I, _P, _P,
                                _P, _P),
    "troy_pack_group_fold": (_P, _P, _L, _I, _I, _I, _I, _P, _P),
    "troy_ntt_mxu": (_P, _P, _L, _I, _I, _I, _P, _I, _P),
    "troy_shard_modsum": (_P, _P, _I, _L, _I, _I, _P, _P),
}

# The kernel each entry point belongs to (the letters of the port's kernel
# list, PERF.md section 6).
KERNELS = {
    "troy_ntt": "A_ntt",
    "troy_ntt_forward_digits": "AF_ntt_digits",
    "troy_ntt_forward_lift": "AGp_ntt_lift",
    "troy_ntt_forward_round": "AO2p_ntt_round",
    "troy_ntt_forward_round_stats": "AO4p_ntt_round_stats",
    "troy_ntt_inverse_pair_convolve": "AP2i_pair_intt",
    "troy_ntt_forward_rescale": "AKp_rescale_ntt",
    "troy_ntt_forward_keyswitch": "AKp_keyswitch_ntt",
    "troy_ntt_forward_bgv_mod_switch": "AKp_bgv_ntt",
    "troy_ntt_forward_bgv_keyswitch": "AKp_bgv_ntt",
    "troy_ntt_inverse_keyswitch": "AFi_keyswitch_intt",
    "troy_ntt_inverse_decrypt_bgv": "AXi_decrypt_intt",
    "troy_ntt_inverse_decrypt_bfv": "ACi_decrypt_intt",
    "troy_dyadic_mac": "B_dyadic_mac",
    "troy_dyadic_convolve": "B_dyadic_mac",
    "troy_base_convert": "C_base_convert",
    "troy_rns_elementwise": "D_rns_elementwise",
    "troy_rns_zero_embed": "DG_zero_embed",
    "troy_behz_lift": "E_behz",
    "troy_behz_tail": "E_behz",
    "troy_behz_decrypt_round": "E_behz",
    "troy_keyswitch_digits": "F_keyswitch",
    "troy_keyswitch_divide_round": "F_keyswitch",
    "troy_mod_switch_divide_round": "K_divide_round",
    "troy_bfv_plain_embed": "G_plain_embed",
    "troy_galois_permute": "M_galois",
    "troy_galois_permute_batched": "M_galois",
    "troy_ckks_fft_encode": "O1_ckks_fft",
    "troy_ckks_fft_decode": "O1_ckks_fft",
    "troy_ckks_round": "O2_ckks_round",
    "troy_ckks_compose": "O3_ckks_compose",
    "troy_ckks_round_stats": "O4_ckks_encode_stats",
    "troy_ckks_fft_decode_stats": "O5_ckks_decode_stats",
    "troy_rescale_ntt_temps": "Kp_rescale_ntt",
    "troy_rescale_ntt_finish": "Kp_rescale_ntt",
    "troy_keyswitch_ntt_temps": "Kp_keyswitch_ntt",
    "troy_keyswitch_ntt_finish": "Kp_keyswitch_ntt",
    "troy_bgv_mod_switch_ntt_temps": "Kp_bgv_ntt",
    "troy_bgv_mod_switch_ntt_finish": "Kp_bgv_ntt",
    "troy_bgv_keyswitch_ntt_temps": "Kp_bgv_ntt",
    "troy_exact_convert": "X_exact_convert",
    "troy_plain_lift": "Gp_plain_lift",
    "troy_sample_uniform_rns": "I_sampling",
    "troy_sample_cbd_rns": "I_sampling",
    "troy_sample_ternary_rns": "I_sampling",
    "troy_sample_zero_sym": "I_sampling",
    "troy_sample_zero_asym": "I_sampling",
    "troy_negacyclic_shift": "N1_negacyclic",
    "troy_extract_lwe": "N1_negacyclic",
    "troy_assemble_lwe": "N1_negacyclic",
    "troy_pack_fold_prepare": "N2_pack_prepare",
    "troy_bgv_divide_coeff": "Kpp_bgv_coeff",
    "troy_tile_contract": "P1_tile_contract",
    "troy_tile_pair_convolve": "P2_pair_convolve",
    "troy_pack_group_fold": "P3_group_fold",
    "troy_ntt_mxu": "J_ntt_mxu",
    "troy_shard_modsum": "R1_shard_modsum",
}

_launches: Dict[str, int] = {name: 0 for name in KERNELS.values()}
_entry_launches: Dict[str, int] = {entry: 0 for entry in KERNELS}
# host ns of each entry point's launches while recording is on
_entry_ns: Dict[str, int] = {entry: 0 for entry in KERNELS}
_lib: Optional[ctypes.CDLL] = None
# each entry point's bound ctypes function, and the raw current-stream
# reader of torch's CUDA build, set when the library loads
_entries: Dict[str, ctypes._CFuncPtr] = {}
_raw_stream = None
build_log = ""
build_seconds = 0.0


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return dict(_launches)


def entry_launch_counts() -> Dict[str, int]:
    """Launches of each entry point since the last reset (a kernel's count
    sums its entry points')."""
    return dict(_entry_launches)


def launch_host_ns() -> Dict[str, int]:
    """Host nanoseconds of each entry point's launches made while recording
    was on (``utils.profiling``), since the last reset: from ``launch``'s
    entry, the arguments' conversion included, to the C call's return."""
    return dict(_entry_ns)


def reset_launch_counts() -> None:
    """Clear the launch counts and ``launch_host_ns``."""
    for name in _launches:
        _launches[name] = 0
    for entry in _entry_launches:
        _entry_launches[entry] = 0
        _entry_ns[entry] = 0


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


def _run_all(cmds) -> str:
    """Run the commands side by side; their joined output, or raise with it
    if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    failed = [c[-1] for c, p in zip(cmds, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    return log


def build() -> Path:
    """Compile the kernels unless a library of these sources exists: one
    nvcc per source, all at once, then one link."""
    global build_log, build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    try:
        build_log = _run_all(
            [[_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
              str(CSRC / s)] for s, o in zip(SOURCES, objs)])
        tmp = path.with_suffix(f".{tag}.so")
        build_log += _run_all([[_nvcc(), "-shared", "-o", str(tmp),
                                *(str(o) for o in objs)]])
        os.replace(tmp, path)
    finally:
        build_seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink(missing_ok=True)
    return path


@profiling.spanned("kernels_load")
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use; binds every entry
    point into ``_entries``."""
    global _lib, _raw_stream
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _entries[name] = fn
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _lib = lib
    return _lib


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on one CUDA device, False if every one lies
    on the CPU (where the plain version runs); raises otherwise."""
    index = tensors[0].get_device()        # -1 on the CPU
    for t in tensors:
        if t.get_device() != index or not (t.is_cuda or t.is_cpu):
            raise ValueError(
                f"tensors on devices {sorted(str(t.device) for t in tensors)}"
                ": expected all on the CPU or all on one CUDA device")
    return index >= 0


def check_operand(t: torch.Tensor, name: str,
                  dtype: torch.dtype = torch.int64) -> None:
    """What every kernel takes: a contiguous CUDA tensor of ``dtype``, by
    default int64 (u64 words)."""
    if t.dtype != dtype:
        what = "int64 u64 words" if dtype == torch.int64 else str(dtype)
        raise TypeError(f"{name}: expected {what}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


def launch(entry: str, device: int, *args) -> None:
    """Call one C entry point on the current stream of CUDA device index
    ``device`` and count the launch. Tensors in ``args`` pass as their data
    pointers, None as NULL."""
    if _lib is None:
        library()
    timed = profiling.active
    if timed:
        t0 = time.perf_counter_ns()
    status = _entries[entry](
        *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
        _raw_stream(device))
    if timed:
        _entry_ns[entry] += time.perf_counter_ns() - t0
    if status != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {status}")
    _launches[KERNELS[entry]] += 1
    _entry_launches[entry] += 1
