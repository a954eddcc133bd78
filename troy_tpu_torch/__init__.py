"""troy_tpu_torch — the PyTorch and CUDA port of troy_tpu.

BFV, CKKS and BGV homomorphic encryption with SEAL semantics (modelled on
lightbulb128/troy) on PyTorch tensors, with hand-written CUDA kernels for
Hopper (sm_90a) on the hot path: the NTT (butterflies in a strided and
a contiguous pass over every SM, the default up to n = 131072, and as
the 4-step transform's stages, each a set of short butterfly transforms
in shared memory, at any n >= 2048, the default above), the 128-bit dyadic
multiply-accumulate, the BEHZ base conversion, per-limb modular
arithmetic, the key switch, the Galois gather, the CKKS embedding in FP64
with the statistics of troy's device encode and decode, the NTT-domain
rescale and BGV divides, the plain lift, the exact
conversion to t, device sampling from threefry streams, the negacyclic
shift with the LWE extract and assemble, the pack tree's shift and fold,
the coefficient-domain BGV divide, and the app layer's tile contraction,
ciphertext pair convolution and group fold (``csrc/``, built with nvcc at
first use). On the CPU every kernel's plain PyTorch version runs instead;
results are the same words (for the FP64 transform, the same values to
rounding). ``app.linear`` holds the private matmul and conv2d helpers,
``serialization`` the wire formats and ``refwire`` troy's raw-struct
bytes, ``compat`` troy's pybind11 binder API (``import
troy_tpu_torch.compat as pytroy``), ``functional`` the explicit-argument
evaluator API, ``valcheck`` and ``hexpoly`` troy's validity checks and
hex-poly strings, ``utils.profiling`` a Timer and a torch.profiler trace,
``native`` the C++ host runtime (host keygen's BLAKE2Xb stream and the
table precompute), built with g++ at first use.

This package imports torch and numpy, never JAX: ``troy_tpu`` is the
reference it is tested against, not a dependency.
"""

from .modulus import Modulus, CoeffModulus, PlainModulus, SecurityLevel
from .params import EncryptionParameters, SchemeType, ParmsID, PARMS_ID_ZERO
from .context import HeContext, ContextData
from .he_types import (Plaintext, Ciphertext, LWECiphertext, SecretKey,
                       PublicKey, KSwitchKeys, RelinKeys, GaloisKeys)
from .keygen import KeyGenerator
from .encryptor import Encryptor
from .decryptor import Decryptor
from .encoder import BatchEncoder
from .ckks import CKKSEncoder, EncodeStats
from .evaluator import Evaluator
from .interop import to_numpy, to_torch
from . import valcheck
from .hexpoly import (poly_to_hex_string, hex_string_to_poly,
                      plaintext_to_string, plaintext_from_string)

__version__ = "0.1.0"

__all__ = [
    "Modulus", "CoeffModulus", "PlainModulus", "SecurityLevel",
    "EncryptionParameters", "SchemeType", "ParmsID", "PARMS_ID_ZERO",
    "HeContext", "ContextData",
    "Plaintext", "Ciphertext", "LWECiphertext", "SecretKey", "PublicKey", "KSwitchKeys",
    "RelinKeys", "GaloisKeys",
    "KeyGenerator", "Encryptor", "Decryptor", "BatchEncoder", "CKKSEncoder",
    "EncodeStats",
    "Evaluator",
    "to_numpy", "to_torch",
    "valcheck", "poly_to_hex_string", "hex_string_to_poly",
    "plaintext_to_string", "plaintext_from_string",
]
