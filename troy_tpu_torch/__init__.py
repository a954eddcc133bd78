"""troy_tpu_torch — the PyTorch and CUDA port of troy_tpu.

BFV homomorphic encryption with SEAL semantics (modelled on
lightbulb128/troy) on PyTorch tensors, with hand-written CUDA kernels for
Hopper (sm_90a) on the hot path: the NTT, the 128-bit dyadic
multiply-accumulate, the BEHZ base conversion and per-limb modular
arithmetic (``csrc/``, built with nvcc at first use). On the CPU every
kernel's plain PyTorch version runs instead; results are the same words.

This package imports torch and numpy, never JAX: ``troy_tpu`` is the
reference it is tested against, not a dependency.
"""

from .modulus import Modulus, CoeffModulus, PlainModulus, SecurityLevel
from .params import EncryptionParameters, SchemeType, ParmsID, PARMS_ID_ZERO
from .context import HeContext, ContextData
from .he_types import Plaintext, Ciphertext, SecretKey, KSwitchKeys, RelinKeys
from .keygen import KeyGenerator
from .encryptor import Encryptor
from .decryptor import Decryptor
from .encoder import BatchEncoder
from .evaluator import Evaluator
from .interop import to_numpy, to_torch

__version__ = "0.1.0"

__all__ = [
    "Modulus", "CoeffModulus", "PlainModulus", "SecurityLevel",
    "EncryptionParameters", "SchemeType", "ParmsID", "PARMS_ID_ZERO",
    "HeContext", "ContextData",
    "Plaintext", "Ciphertext", "SecretKey", "KSwitchKeys", "RelinKeys",
    "KeyGenerator", "Encryptor", "Decryptor", "BatchEncoder", "Evaluator",
    "to_numpy", "to_torch",
]
