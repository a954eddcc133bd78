"""troy's pybind11 binder API on the port.

troy ships a Python module ``pytroy`` (binder/binder.cu:144-846) whose
objects are mutable and whose methods come in pairs, one returning a new
object and an ``*_inplace`` one, many with an out-parameter. This module
puts the port's classes behind that surface, as troy_tpu/compat does for
the JAX package, so troy's users switch with

    import troy_tpu_torch.compat as pytroy

Each wrapper holds the port's immutable object in ``_inner`` and swaps it
on mutation; an out-parameter takes the result's inner object
(``_assign_or_return``), and ``copy()`` shares it, which is safe because no
op of the port writes a ciphertext's tensor in place. Contexts carry the
mapping between troy's ParmsIDs and the port's chain levels.

``save()`` writes the port's own formats (TCT1, TPT1, TKY1:
serialization.py) and ``save(context, wire="troy")`` troy's raw-struct
bytes (refwire.py); ``load`` tells them apart by their magic. Everything
lives on the device of the context (``SEALContext(..., device=None)``: the
card, ``device="cpu"`` for the kernels' plain versions); a load given no
context uses the most recently made one, as does a plaintext's or a
ciphertext's ``parms_id()``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

import troy_tpu_torch as _t
from troy_tpu_torch import _kernels, native
from troy_tpu_torch import refwire as _rw
from troy_tpu_torch import serialization as _ser
from troy_tpu_torch.app import linear as _lin
from troy_tpu_torch.hexpoly import plaintext_to_string

SchemeType = _t.SchemeType
SecurityLevel = _t.SecurityLevel
Modulus = _t.Modulus


def initialize_kernel() -> None:
    """Build (nvcc, at first use) and load the CUDA kernels and the native
    host runtime, as troy's initialize_kernel -> KernelProvider::initialize
    readies the card; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("initialize_kernel: CUDA is not available")
    torch.cuda.init()
    _kernels.library()
    native.available()


class Smoke:
    """Binder smoke-test class (binder.cu:33-39, bound at :147-151)."""

    def __init__(self, i: int = 19991111):
        self.t = int(i)

    def hello(self):
        print(f"Hello I am Smoking ... {self.t}")


class ParmsID(bytes):
    """The 32-byte parameter hash (binder.cu ParmsID, :186-193); compares
    equal to the plain digest. ``vec()`` gives its four little-endian
    64-bit words (troy's binder returns an empty list there: its lambda
    loops over a vector it only reserved)."""

    def vec(self) -> List[int]:
        return list(struct.unpack("<4Q", self))


class CoeffModulus:
    @staticmethod
    def max_bit_count(poly_modulus_degree: int,
                      sec_level: SecurityLevel = SecurityLevel.tc128) -> int:
        return _t.CoeffModulus.max_bit_count(poly_modulus_degree, sec_level)

    @staticmethod
    def bfv_default(poly_modulus_degree: int,
                    sec_level: SecurityLevel = SecurityLevel.tc128):
        return list(_t.CoeffModulus.bfv_default(poly_modulus_degree,
                                                sec_level))

    @staticmethod
    def create(poly_modulus_degree: int, bit_sizes: Sequence[int]):
        return list(_t.CoeffModulus.create(poly_modulus_degree,
                                           list(bit_sizes)))


class PlainModulus:
    @staticmethod
    def batching(poly_modulus_degree: int, bit_size: int) -> Modulus:
        return _t.PlainModulus.batching(poly_modulus_degree, bit_size)


class EncryptionParameters:
    """The mutable parameter builder (binder.cu EncryptionParameters)."""

    def __init__(self, scheme: SchemeType):
        self._scheme = scheme
        self._n = 0
        self._coeff: List[Modulus] = []
        self._plain = Modulus(0)

    def set_poly_modulus_degree(self, n: int):
        self._n = n

    def set_coeff_modulus(self, moduli: Sequence[Modulus]):
        self._coeff = [m if isinstance(m, Modulus) else Modulus(int(m))
                       for m in moduli]

    def set_plain_modulus(self, t: Union[int, Modulus]):
        self._plain = t if isinstance(t, Modulus) else Modulus(int(t))

    def scheme(self) -> SchemeType:
        return self._scheme

    def poly_modulus_degree(self) -> int:
        return self._n

    def coeff_modulus(self) -> List[Modulus]:
        return list(self._coeff)

    def _freeze(self) -> _t.EncryptionParameters:
        return _t.EncryptionParameters(
            scheme=self._scheme, poly_modulus_degree=self._n,
            coeff_modulus=tuple(self._coeff), plain_modulus=self._plain)

    def parms_id(self):
        return ParmsID(self._freeze().parms_id)


def _rebuild_parms(inner) -> EncryptionParameters:
    """A level's frozen parameters as the mutable builder (ContextData::
    parms, binder.cu:211)."""
    p = EncryptionParameters(inner.scheme)
    p.set_poly_modulus_degree(inner.poly_modulus_degree)
    p.set_coeff_modulus(list(inner.coeff_modulus))
    p.set_plain_modulus(inner.plain_modulus)
    return p


class ContextData:
    def __init__(self, ctx: "SEALContext", level: int):
        self._ctx = ctx
        self._level = level
        self._cd = ctx._inner.get_context_data(level)

    def parms(self) -> EncryptionParameters:
        return _rebuild_parms(self._cd.parms)

    def parms_id(self):
        return ParmsID(self._cd.parms_id)

    def chain_index(self) -> int:
        # troy counts chain indices down (the last level is 0)
        return len(self._ctx._inner.chain) - 1 - self._level

    def prev_context_data(self):
        return (ContextData(self._ctx, self._level - 1)
                if self._level > 0 else None)

    def next_context_data(self):
        return (ContextData(self._ctx, self._level + 1)
                if self._level + 1 < len(self._ctx._inner.chain) else None)


# ParmsID <-> chain level, so that a detached Plaintext or Ciphertext can
# answer the binder's parms_id/set_parms_id (binder.cu:237-268) without a
# context. ParmsIDs hash the whole parameter set, so contexts cannot
# collide; level -> ParmsID and the context of a load given none are the
# most recently made context's.
_PARMS_TO_LEVEL: dict = {}
_LEVEL_TO_PARMS: dict = {}
_CURRENT: List["SEALContext"] = []


def _current() -> "SEALContext":
    if not _CURRENT:
        raise ValueError("no SEALContext made yet: pass a context")
    return _CURRENT[0]


def _inner_ctx(context: Optional["SEALContext"]) -> _t.HeContext:
    return (context or _current())._inner


def _ref_ctx(context: Optional["SEALContext"], what: str) -> _t.HeContext:
    """troy's byte layouts embed a context's ParmsID, so save(wire="troy")
    needs the context the loads need: say so, not AttributeError."""
    if context is None:
        raise ValueError(f'{what}.save(wire="troy") needs a context '
                         "(troy's layout embeds its ParmsID)")
    return context._inner


class SEALContext:
    """The parameter chain (binder.cu SEALContext) on ``device``: the card
    unless the caller names another (``device="cpu"``)."""

    def __init__(self, parms: EncryptionParameters,
                 expand_mod_chain: bool = True,
                 sec_level: SecurityLevel = SecurityLevel.tc128,
                 device=None):
        self._inner = _t.HeContext(parms._freeze(),
                                   expand_mod_chain=expand_mod_chain,
                                   sec_level=sec_level, device=device)
        _LEVEL_TO_PARMS.clear()
        for cd in self._inner.chain:
            _PARMS_TO_LEVEL[bytes(cd.parms_id)] = cd.chain_index
            _LEVEL_TO_PARMS[cd.chain_index] = bytes(cd.parms_id)
        _CURRENT[:] = [self]

    @property
    def device(self) -> torch.device:
        return self._inner.device

    def _level_of(self, parms_id) -> int:
        cd = self._inner.get_context_data_by_parms_id(bytes(parms_id))
        if cd is None:
            raise ValueError("unknown parms_id for this context")
        return cd.chain_index

    def get_context_data(self, parms_id) -> ContextData:
        return ContextData(self, self._level_of(parms_id))

    def first_context_data(self) -> ContextData:
        return ContextData(self, self._inner.first_level)

    def last_context_data(self) -> ContextData:
        return ContextData(self, self._inner.last_level)

    def key_context_data(self) -> ContextData:
        return ContextData(self, 0)

    def first_parms_id(self):
        return ParmsID(self._inner.first_context_data.parms_id)

    def last_parms_id(self):
        return ParmsID(self._inner.last_context_data.parms_id)

    def key_parms_id(self):
        return ParmsID(self._inner.key_context_data.parms_id)

    def using_keyswitching(self) -> bool:
        return self._inner.using_keyswitching


class _Wrapper:
    """The mutable wrapper of one immutable object of the port."""

    _inner = None

    def __init__(self, inner=None):
        self._inner = inner

    def copy(self):
        c = type(self)()
        c._inner = self._inner
        return c


def _level_pid(level) -> ParmsID:
    return ParmsID(_LEVEL_TO_PARMS.get(level, _t.PARMS_ID_ZERO))


def _load_either(raw: bytes, magic: bytes, native_load, ref_load,
                 context: Optional[SEALContext], what: str):
    """A native stream (by its magic) or troy's layout, which needs the
    context to map its ParmsID."""
    if raw[:len(magic)] == magic:
        return native_load(raw)
    if context is None:
        raise ValueError(f"not a native {what} stream; loading troy-format "
                         "bytes needs a context")
    return ref_load(raw, context._inner)


class Plaintext(_Wrapper):
    def set_zero(self):
        self._inner = dataclasses.replace(
            self._inner, data=torch.zeros_like(self._inner.data))

    def coeff_count(self) -> int:
        return int(self._inner.coeff_count)

    def is_ntt_form(self) -> bool:
        return self._inner.is_ntt_form

    def scale(self) -> float:
        return self._inner.scale

    def set_scale(self, s: float):
        self._inner = dataclasses.replace(self._inner, scale=float(s))

    def to_string(self) -> str:
        return plaintext_to_string(self._inner)

    def parms_id(self):
        """The ParmsID of the plaintext's level (binder.cu:237); a mod-t
        plaintext has none: zero."""
        return _level_pid(self._inner.level)

    def set_parms_id(self, parms_id):
        self._inner = dataclasses.replace(
            self._inner, level=_PARMS_TO_LEVEL[bytes(parms_id)])

    def save(self, context: Optional[SEALContext] = None,
             wire: str = "native") -> bytes:
        """TPT1, or with wire="troy" PlaintextCuda::save's bytes."""
        if wire == "troy":
            return _rw.save_plaintext_ref(self._inner,
                                          _ref_ctx(context, "Plaintext"))
        return _ser.save_plaintext(self._inner)

    def load(self, raw: bytes, context: Optional[SEALContext] = None):
        self._inner = _load_either(
            raw, b"TPT1", lambda r: _ser.load_plaintext(
                r, _inner_ctx(context).device),
            _rw.load_plaintext_ref, context, "TPT1")


class Ciphertext(_Wrapper):
    def correction_factor(self) -> int:
        return self._inner.correction_factor

    def set_correction_factor(self, c: int):
        self._inner = dataclasses.replace(self._inner,
                                          correction_factor=int(c))

    def scale(self) -> float:
        return self._inner.scale

    def set_scale(self, s: float):
        self._inner = dataclasses.replace(self._inner, scale=float(s))

    def is_ntt_form(self) -> bool:
        return self._inner.is_ntt_form

    def coeff_modulus_size(self) -> int:
        return int(self._inner.limbs)

    def poly_modulus_degree(self) -> int:
        return int(self._inner.n)

    def size(self) -> int:
        return int(self._inner.size)

    def parms_id(self):
        return _level_pid(self._inner.level)

    def set_parms_id(self, parms_id):
        self._inner = dataclasses.replace(
            self._inner, level=_PARMS_TO_LEVEL[bytes(parms_id)])

    def resize(self, size: int):
        """Grow with zero components or drop the last ones
        (binder.cu:265 Ciphertext::resize)."""
        data, size = self._inner.data, int(size)
        if size < data.shape[0]:
            data = data[:size]
        elif size > data.shape[0]:
            data = torch.cat([data, data.new_zeros(
                (size - data.shape[0],) + tuple(data.shape[1:]))])
        self._inner = self._inner.replace(data=data)

    def reserve(self, size: int):
        """Nothing to do: PyTorch's allocator owns capacity
        (binder.cu:266)."""

    def save(self, context: Optional[SEALContext] = None,
             wire: str = "native") -> bytes:
        """TCT1 (c0 and the seed of a seed-compressed ciphertext), or with
        wire="troy" CiphertextCuda::save's bytes (expanded first)."""
        if wire == "troy":
            return _rw.save_ciphertext_ref(self._inner,
                                           _ref_ctx(context, "Ciphertext"))
        return _ser.save_ciphertext(self._inner)

    def load(self, raw: bytes, context: Optional[SEALContext] = None):
        """TCT1 (a seeded stream expands against the context) or troy's
        layout (binder.cu load, with and without a context)."""
        self._inner = _load_either(
            raw, b"TCT1",
            lambda r: _ser.load_ciphertext(r, _inner_ctx(context)),
            _rw.load_ciphertext_ref, context, "TCT1")

    def save_terms(self, evaluator: "Evaluator", terms) -> bytes:
        return _ser.save_terms(self._inner, evaluator._ctx,
                               [int(x) for x in np.asarray(terms)])

    def load_terms(self, raw: bytes, evaluator: "Evaluator", terms):
        self._inner = _ser.load_terms(raw, evaluator._ctx,
                                      [int(x) for x in np.asarray(terms)])


class LWECiphertext(_Wrapper):
    pass


def _key_class(name: str, save_native, load_native, save_ref, load_ref):
    """A key wrapper: save/load in the native TKY1 layout or troy's."""

    def save(self, context: Optional[SEALContext] = None,
             wire: str = "native") -> bytes:
        if wire == "troy":
            return save_ref(self._inner, _ref_ctx(context, name))
        return save_native(self._inner)

    def load(self, raw: bytes, context: Optional[SEALContext] = None):
        self._inner = _load_either(
            raw, b"TKY1",
            lambda r: load_native(r, _inner_ctx(context).device), load_ref,
            context, "TKY1")

    return type(name, (_Wrapper,), {"save": save, "load": load,
                                    "__module__": __name__})


SecretKey = _key_class("SecretKey", _ser.save_secret_key,
                       _ser.load_secret_key, _rw.save_secret_key_ref,
                       _rw.load_secret_key_ref)
PublicKey = _key_class("PublicKey", _ser.save_public_key,
                       _ser.load_public_key, _rw.save_public_key_ref,
                       _rw.load_public_key_ref)
RelinKeys = _key_class("RelinKeys", _ser.save_relin_keys,
                       _ser.load_relin_keys, _rw.save_relin_keys_ref,
                       _rw.load_relin_keys_ref)
GaloisKeys = _key_class("GaloisKeys", _ser.save_galois_keys,
                        _ser.load_galois_keys, _rw.save_galois_keys_ref,
                        _rw.load_galois_keys_ref)


class KSwitchKeys(_Wrapper):
    def save(self) -> bytes:
        return _ser.save_kswitch_keys(self._inner)

    def load(self, raw: bytes, context: Optional[SEALContext] = None):
        self._inner = _ser.load_kswitch_keys(raw,
                                             _inner_ctx(context).device)


def _out(result, out, cls):
    """The binder's two styles: return a new wrapper, or fill ``out``."""
    if out is None:
        return cls(result)
    out._inner = result
    return out


def _assign_or_return(result, out: Optional[Ciphertext]) -> Ciphertext:
    return _out(result, out, Ciphertext)


class KeyGenerator:
    def __init__(self, context: SEALContext, seed: Optional[bytes] = None):
        self._inner = _t.KeyGenerator(context._inner, seed=seed)

    def secret_key(self) -> SecretKey:
        return SecretKey(self._inner.secret_key)

    def create_public_key(self, out: Optional[PublicKey] = None):
        """Assign-return or out-parameter (binder/timetest.py
        ``keygen.create_public_key(self.pk)``)."""
        return _out(self._inner.create_public_key(), out, PublicKey)

    def create_relin_keys(self, out: Optional[RelinKeys] = None):
        return _out(self._inner.create_relin_keys(), out, RelinKeys)

    def create_galois_keys(self, steps=None,
                           out: Optional[GaloisKeys] = None):
        """The binder's overloads: (), (steps), (out), (steps, out)."""
        if isinstance(steps, GaloisKeys):
            steps, out = None, steps
        return _out(self._inner.create_galois_keys(steps=steps), out,
                    GaloisKeys)

    def create_automorphism_keys(self, out: Optional[GaloisKeys] = None):
        return _out(self._inner.create_automorphism_keys(), out, GaloisKeys)

    def create_keyswitching_keys(self, new_key: SecretKey) -> KSwitchKeys:
        return KSwitchKeys(self._inner.create_keyswitch_key(new_key._inner))


class BatchEncoder:
    def __init__(self, context: SEALContext):
        self._inner = _t.BatchEncoder(context._inner)

    def slot_count(self) -> int:
        return self._inner.slot_count

    def encode(self, values, out: Optional[Plaintext] = None) -> Plaintext:
        return _out(self._inner.encode(np.asarray(values, dtype=np.uint64)),
                    out, Plaintext)

    def encode_int64(self, values,
                     out: Optional[Plaintext] = None) -> Plaintext:
        return _out(self._inner.encode_signed(
            np.asarray(values, dtype=np.int64)), out, Plaintext)

    def encode_polynomial(self, values,
                          out: Optional[Plaintext] = None) -> Plaintext:
        return _out(self._inner.encode_polynomial(
            np.asarray(values, dtype=np.uint64)), out, Plaintext)

    def decode(self, plain: Plaintext) -> np.ndarray:
        return np.asarray(self._inner.decode(plain._inner))

    def decode_int64(self, plain: Plaintext) -> np.ndarray:
        return np.asarray(self._inner.decode_signed(plain._inner))

    def decode_polynomial(self, plain: Plaintext) -> np.ndarray:
        return np.asarray(self._inner.decode_polynomial(plain._inner))


class CKKSEncoder:
    """encode runs the port's CKKSEncoder.encode: O1, O2 and A, or, where
    the host bound scale * max|v| reaches Q/2, O4 and troy's exact
    magnitude check."""

    def __init__(self, context: SEALContext):
        self._ctx = context
        self._inner = _t.CKKSEncoder(context._inner)

    def slot_count(self) -> int:
        return self._inner.slot_count

    def _level(self, parms_id) -> Optional[int]:
        return None if parms_id is None else self._ctx._level_of(parms_id)

    @staticmethod
    def _split_args(args):
        """(scale[, out]) or (parms_id, scale[, out]): the binder's
        overloads, told apart by type."""
        out = None
        if args and isinstance(args[-1], Plaintext):
            out, args = args[-1], args[:-1]
        if len(args) == 1:
            return None, float(args[0]), out
        if len(args) == 2:
            return args[0], float(args[1]), out
        raise TypeError("encode expects (values, [parms_id,] scale"
                        "[, plaintext_out])")

    def encode(self, values, *args) -> Plaintext:
        parms_id, scale, out = self._split_args(args)
        level = self._level(parms_id)
        if np.isscalar(values) or np.asarray(values).ndim == 0:
            return _out(self._inner.encode_constant(complex(values), scale,
                                                    level), out, Plaintext)
        return _out(self._inner.encode(np.asarray(values), scale, level),
                    out, Plaintext)

    def encode_polynomial(self, values, *args) -> Plaintext:
        parms_id, scale, out = self._split_args(args)
        return _out(self._inner.encode_polynomial(
            np.asarray(values, dtype=np.float64), scale,
            self._level(parms_id)), out, Plaintext)

    def decode(self, plain: Plaintext) -> np.ndarray:
        return np.asarray(self._inner.decode(plain._inner))

    def decode_polynomial(self, plain: Plaintext) -> np.ndarray:
        return np.asarray(self._inner.decode_polynomial(plain._inner))


class Encryptor:
    def __init__(self, context: SEALContext,
                 key1: Union[PublicKey, SecretKey, None] = None,
                 key2: Optional[SecretKey] = None):
        self._ctx = context
        pk = key1._inner if isinstance(key1, PublicKey) else None
        sk = key1._inner if isinstance(key1, SecretKey) else None
        if isinstance(key2, SecretKey):
            sk = key2._inner
        self._inner = _t.Encryptor(context._inner, public_key=pk,
                                   secret_key=sk)

    def set_public_key(self, pk: PublicKey):
        self._inner._pk = pk._inner
        self._inner._pk_levels.clear()

    def set_secret_key(self, sk: SecretKey):
        self._inner._sk = sk._inner

    def encrypt(self, plain: Plaintext,
                out: Optional[Ciphertext] = None) -> Ciphertext:
        return _assign_or_return(self._inner.encrypt(plain._inner), out)

    def encrypt_symmetric(self, plain: Plaintext,
                          out: Optional[Ciphertext] = None,
                          save_seed: bool = False) -> Ciphertext:
        """save_seed=True keeps the seed of c1, so save() writes the
        compressed form (troy's Serializable<Ciphertext>)."""
        return _assign_or_return(self._inner.encrypt_symmetric(
            plain._inner, save_seed=save_seed), out)

    def _zero_level(self, parms_id) -> Optional[int]:
        return None if parms_id is None else self._ctx._level_of(parms_id)

    def encrypt_zero(self, parms_id=None) -> Ciphertext:
        return Ciphertext(self._inner.encrypt_zero(
            self._zero_level(parms_id), asymmetric=True))

    def encrypt_zero_symmetric(self, parms_id=None) -> Ciphertext:
        return Ciphertext(self._inner.encrypt_zero(
            self._zero_level(parms_id), asymmetric=False))


class Decryptor:
    def __init__(self, context: SEALContext, secret_key: SecretKey):
        self._inner = _t.Decryptor(context._inner, secret_key._inner)

    def decrypt(self, ct: Ciphertext,
                out: Optional[Plaintext] = None) -> Plaintext:
        return _out(self._inner.decrypt(ct._inner), out, Plaintext)

    def invariant_noise_budget(self, ct: Ciphertext) -> int:
        return self._inner.invariant_noise_budget(ct._inner)


def _pair(name: str, operands: int):
    """``name(c, *operands[, out])`` and ``name_inplace(c, *operands)`` on
    the port's Evaluator method of that name; wrapped operands pass their
    inner objects."""

    def unwrap(a):
        return a._inner if isinstance(a, _Wrapper) else a

    def assign(self, c, *args, out: Optional[Ciphertext] = None):
        if len(args) > operands:
            args, out = args[:operands], args[operands]
        return _assign_or_return(getattr(self._inner, name)(
            c._inner, *map(unwrap, args)), out)

    def inplace(self, c, *args):
        c._inner = getattr(self._inner, name)(c._inner, *map(unwrap, args))

    assign.__name__, inplace.__name__ = name, f"{name}_inplace"
    return assign, inplace


class Evaluator:
    """Every op of the binder's Evaluator (binder.cu:560-700) on the port's
    Evaluator: assign-return with an optional out-parameter last, and the
    ``*_inplace`` twin."""

    def __init__(self, context: SEALContext):
        self._compat_ctx = context
        self._ctx = context._inner
        self._inner = _t.Evaluator(context._inner)

    negate, negate_inplace = _pair("negate", 0)
    add, add_inplace = _pair("add", 1)
    sub, sub_inplace = _pair("sub", 1)
    multiply, multiply_inplace = _pair("multiply", 1)
    square, square_inplace = _pair("square", 0)
    relinearize, relinearize_inplace = _pair("relinearize", 1)
    apply_keyswitching, apply_keyswitching_inplace = _pair(
        "apply_keyswitching", 1)
    rescale_to_next, rescale_to_next_inplace = _pair("rescale_to_next", 0)
    add_plain, add_plain_inplace = _pair("add_plain", 1)
    sub_plain, sub_plain_inplace = _pair("sub_plain", 1)
    multiply_plain, multiply_plain_inplace = _pair("multiply_plain", 1)
    transform_from_ntt, transform_from_ntt_inplace = _pair(
        "transform_from_ntt", 0)
    rotate_rows, rotate_rows_inplace = _pair("rotate_rows", 2)
    rotate_columns, rotate_columns_inplace = _pair("rotate_columns", 1)
    rotate_vector, rotate_vector_inplace = _pair("rotate_vector", 2)
    complex_conjugate, complex_conjugate_inplace = _pair(
        "complex_conjugate", 1)
    negacyclic_shift, negacyclic_shift_inplace = _pair("negacyclic_shift", 1)
    apply_galois, apply_galois_inplace = _pair("apply_galois", 2)

    def add_many(self, cts: Sequence[Ciphertext],
                 out: Optional[Ciphertext] = None):
        return _assign_or_return(
            self._inner.add_many([c._inner for c in cts]), out)

    def multiply_many(self, cts: Sequence[Ciphertext],
                      relin_keys: RelinKeys,
                      out: Optional[Ciphertext] = None):
        return _assign_or_return(self._inner.multiply_many(
            [c._inner for c in cts], relin_keys._inner), out)

    def exponentiate(self, c: Ciphertext, power: int, relin_keys: RelinKeys,
                     out: Optional[Ciphertext] = None):
        return _assign_or_return(self._inner.exponentiate(
            c._inner, int(power), relin_keys._inner), out)

    def exponentiate_inplace(self, c: Ciphertext, power: int,
                             relin_keys: RelinKeys):
        c._inner = self._inner.exponentiate(c._inner, int(power),
                                            relin_keys._inner)

    # ---- the ciphertext-or-plaintext overloads ----
    def _lvl(self, parms_id) -> int:
        return self._compat_ctx._level_of(parms_id)

    def _mod_switch(self, obj, level: Optional[int]):
        ev = self._inner
        if isinstance(obj, Plaintext):
            return (ev.mod_switch_plain_to_next(obj._inner) if level is None
                    else ev.mod_switch_plain_to(obj._inner, level))
        return (ev.mod_switch_to_next(obj._inner) if level is None
                else ev.mod_switch_to(obj._inner, level))

    def mod_switch_to_next(self, obj, out=None):
        return _out(self._mod_switch(obj, None), out, type(obj))

    def mod_switch_to_next_inplace(self, obj):
        obj._inner = self._mod_switch(obj, None)

    def mod_switch_to(self, obj, parms_id, out=None):
        return _out(self._mod_switch(obj, self._lvl(parms_id)), out,
                    type(obj))

    def mod_switch_to_inplace(self, obj, parms_id):
        obj._inner = self._mod_switch(obj, self._lvl(parms_id))

    def rescale_to(self, c: Ciphertext, parms_id,
                   out: Optional[Ciphertext] = None):
        return _assign_or_return(
            self._inner.rescale_to(c._inner, self._lvl(parms_id)), out)

    def rescale_to_inplace(self, c: Ciphertext, parms_id):
        c._inner = self._inner.rescale_to(c._inner, self._lvl(parms_id))

    def multiply_plain_1000(self, c: Ciphertext, p: Plaintext) -> Ciphertext:
        """The binder's benchmark helper: 1000 multiply_plain calls
        (binder.cu:637)."""
        ret = None
        for _ in range(1000):
            ret = self._inner.multiply_plain(c._inner, p._inner)
        return Ciphertext(ret)

    def multiply_batch(self, cs: Sequence[Ciphertext],
                       ps: Sequence[Plaintext]) -> List[Ciphertext]:
        """multiply_plain over pairs of two sequences (binder.cu:644)."""
        return [Ciphertext(self._inner.multiply_plain(c._inner, p._inner))
                for c, p in zip(cs, ps)]

    def _to_ntt(self, obj, parms_id):
        if isinstance(obj, Plaintext):
            level = (self._ctx.first_level if parms_id is None
                     else self._lvl(parms_id))
            return self._inner.transform_plain_to_ntt(obj._inner, level)
        return self._inner.transform_to_ntt(obj._inner)

    def transform_to_ntt(self, obj, parms_id=None, out=None):
        return _out(self._to_ntt(obj, parms_id), out, type(obj))

    def transform_to_ntt_inplace(self, obj, parms_id=None):
        obj._inner = self._to_ntt(obj, parms_id)

    # ---- beyond the binder: the hoisted path and batched LWE ----
    def rotate_many(self, c: Ciphertext, steps: Sequence[int],
                    galois_keys: GaloisKeys) -> List[Ciphertext]:
        """Hoisted rotations of one ciphertext (Evaluator.rotate_many)."""
        return [Ciphertext(r) for r in self._inner.rotate_many(
            c._inner, [int(s) for s in steps], galois_keys._inner)]

    def apply_galois_many(self, c: Ciphertext, galois_elts: Sequence[int],
                          galois_keys: GaloisKeys) -> List[Ciphertext]:
        return [Ciphertext(r) for r in self._inner.apply_galois_many(
            c._inner, [int(e) for e in galois_elts], galois_keys._inner)]

    def extract_lwe_many(self, c: Ciphertext,
                         terms: Sequence[int]) -> List[LWECiphertext]:
        return [LWECiphertext(x) for x in self._inner.extract_lwe_many(
            c._inner, [int(t) for t in terms])]

    # ---- LWE (troy) ----
    def extract_lwe(self, c: Ciphertext, term: int) -> LWECiphertext:
        return LWECiphertext(self._inner.extract_lwe(c._inner, int(term)))

    def assemble_lwe(self, lwe: LWECiphertext) -> Ciphertext:
        return Ciphertext(self._inner.assemble_lwe(lwe._inner))

    def field_trace_inplace(self, c: Ciphertext, auto_keys: GaloisKeys,
                            logn: int):
        c._inner = self._inner.field_trace(c._inner, auto_keys._inner,
                                           int(logn))

    def divide_by_poly_modulus_degree_inplace(self, c: Ciphertext,
                                              mul: Optional[int] = None):
        """Every coefficient times n^-1 (times ``mul``, 1 by default, as
        troy's divideByPolyModulusDegreeInplace)."""
        c._inner = self._inner.divide_by_poly_modulus_degree(
            c._inner, 1 if mul is None else int(mul))

    def pack_lwe_ciphertexts(self, lwes: Sequence[LWECiphertext],
                             auto_keys: GaloisKeys) -> Ciphertext:
        return Ciphertext(self._inner.pack_lwe_ciphertexts(
            [x._inner for x in lwes], auto_keys._inner))


class Plain2d:
    def __init__(self, inner: Optional[_lin.Plain2d] = None):
        self._inner = inner or _lin.Plain2d()

    def encrypt(self, encryptor: Encryptor) -> "Cipher2d":
        return Cipher2d(self._inner.encrypt(encryptor._inner))

    def encrypt_symmetric(self, encryptor: Encryptor) -> "Cipher2d":
        return Cipher2d(self._inner.encrypt_symmetric(encryptor._inner))


class Cipher2d:
    def __init__(self, inner: Optional[_lin.Cipher2d] = None):
        self._inner = inner or _lin.Cipher2d()

    def save(self) -> bytes:
        return self._inner.save()

    def load(self, raw: bytes, context: SEALContext):
        self._inner = _lin.Cipher2d.load(raw, context._inner)

    def add_inplace(self, evaluator: Evaluator, other: "Cipher2d"):
        self._inner = self._inner.add(evaluator._inner, other._inner)

    def add_plain_inplace(self, evaluator: Evaluator, other: Plain2d):
        self._inner = self._inner.add_plain(evaluator._inner, other._inner)

    def add_plain(self, evaluator: Evaluator, other: Plain2d) -> "Cipher2d":
        return Cipher2d(self._inner.add_plain(evaluator._inner,
                                              other._inner))

    def mod_switch_to_next(self, evaluator: Evaluator):
        self._inner = self._inner.mod_switch_to_next(evaluator._inner)

    def relinearize(self, evaluator: Evaluator, rlk: RelinKeys):
        self._inner = self._inner.relinearize(evaluator._inner, rlk._inner)

    def switch_key(self, evaluator: Evaluator, ksk: KSwitchKeys):
        self._inner = self._inner.switch_key(evaluator._inner, ksk._inner)

    def multiply_scalar_inplace(self, encoder, evaluator: Evaluator,
                                scalar: int):
        self._inner = self._inner.multiply_scalar(
            evaluator._inner, _codec(encoder)[0], int(scalar))


def _codec(encoder):
    """(encode_polynomial, decode_polynomial) of a wrapped or bare
    encoder."""
    enc = getattr(encoder, "_inner", encoder)
    return enc.encode_polynomial, enc.decode_polynomial


def _u64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


class _Helper:
    """What MatmulHelper and Conv2dHelper share (binder.cu:760-846)."""

    _inner = None

    def encode_weights(self, encoder, weights) -> Plain2d:
        return Plain2d(self._inner.encode_weights(_codec(encoder)[0],
                                                  _u64(weights)))

    def encode_inputs(self, encoder, inputs) -> Plain2d:
        return Plain2d(self._inner.encode_inputs(_codec(encoder)[0],
                                                 _u64(inputs)))

    def encrypt_inputs(self, encryptor: Encryptor, encoder,
                       inputs) -> Cipher2d:
        return Cipher2d(self._inner.encrypt_inputs(
            encryptor._inner, _codec(encoder)[0], _u64(inputs)))

    def _dispatch(self, evaluator: Evaluator, a, w, what: str) -> Cipher2d:
        """The binder's overloads by operand type (binder.cu:773-781,
        :824-832): (Cipher2d, Plain2d), (Cipher2d, Cipher2d) and
        (Plain2d, Cipher2d)."""
        ev = evaluator._inner
        if isinstance(a, Cipher2d) and isinstance(w, Plain2d):
            fn = getattr(self._inner, what)
        elif isinstance(a, Cipher2d) and isinstance(w, Cipher2d):
            fn = getattr(self._inner, f"{what}_cipher")
        elif isinstance(a, Plain2d) and isinstance(w, Cipher2d):
            fn = getattr(self._inner, f"{what}_reverse")
        else:
            raise TypeError(f"{what} expects (Cipher2d, Plain2d), "
                            "(Cipher2d, Cipher2d) or (Plain2d, Cipher2d)")
        return Cipher2d(fn(ev, a._inner, w._inner))

    def serialize_outputs(self, evaluator: Evaluator, x: Cipher2d) -> bytes:
        return self._inner.serialize_outputs(evaluator._inner,
                                             evaluator._ctx, x._inner)

    def deserialize_outputs(self, evaluator: Evaluator,
                            raw: bytes) -> Cipher2d:
        return Cipher2d(self._inner.deserialize_outputs(
            evaluator._inner, evaluator._ctx, raw))

    def decrypt_outputs(self, encoder, decryptor: Decryptor,
                        outputs: Cipher2d) -> np.ndarray:
        return self._inner.decrypt_outputs(_codec(encoder)[1],
                                           decryptor._inner, outputs._inner)

    def encode_outputs(self, encoder, outputs) -> Plain2d:
        return Plain2d(self._inner.encode_outputs(_codec(encoder)[0],
                                                  _u64(outputs)))


class MatmulHelper(_Helper):
    def __init__(self, batch_size: int, input_dims: int, output_dims: int,
                 slot_count: int, objective: int = 0,
                 pack_lwe: bool = True):
        self._inner = _lin.MatmulHelper(batch_size, input_dims, output_dims,
                                        slot_count, objective=objective,
                                        pack_lwe=pack_lwe)

    def matmul(self, evaluator: Evaluator, a, w) -> Cipher2d:
        return self._dispatch(evaluator, a, w, "matmul")

    def matmul_cipher(self, evaluator: Evaluator, a: Cipher2d,
                      w: Cipher2d) -> Cipher2d:
        return Cipher2d(self._inner.matmul_cipher(evaluator._inner,
                                                  a._inner, w._inner))

    def matmul_reverse(self, evaluator: Evaluator, a: Plain2d,
                       w: Cipher2d) -> Cipher2d:
        return Cipher2d(self._inner.matmul_reverse(evaluator._inner,
                                                   a._inner, w._inner))

    def pack_outputs(self, evaluator: Evaluator, auto_keys: GaloisKeys,
                     cipher: Cipher2d) -> Cipher2d:
        return Cipher2d(self._inner.pack_outputs(
            evaluator._inner, auto_keys._inner, cipher._inner))

    def serialize_encoded_weights(self, w: Plain2d) -> bytes:
        return self._inner.serialize_encoded_weights(w._inner)

    def deserialize_encoded_weights(self, raw: bytes) -> Plain2d:
        return Plain2d(self._inner.deserialize_encoded_weights(
            raw, _current().device))


class Conv2dHelper(_Helper):
    def __init__(self, batch_size: int, image_height: int, image_width: int,
                 kernel_height: int, kernel_width: int,
                 input_channels: int, output_channels: int,
                 slot_count: int, objective: int = 0):
        self._inner = _lin.Conv2dHelper(
            batch_size, image_height, image_width, kernel_height,
            kernel_width, input_channels, output_channels, slot_count,
            objective=objective)

    def conv2d(self, evaluator: Evaluator, a, w) -> Cipher2d:
        return self._dispatch(evaluator, a, w, "conv2d")

    def conv2d_cipher(self, evaluator: Evaluator, a: Cipher2d,
                      w: Cipher2d) -> Cipher2d:
        return Cipher2d(self._inner.conv2d_cipher(evaluator._inner,
                                                  a._inner, w._inner))

    def conv2d_reverse(self, evaluator: Evaluator, a: Plain2d,
                       w: Cipher2d) -> Cipher2d:
        return Cipher2d(self._inner.conv2d_reverse(evaluator._inner,
                                                   a._inner, w._inner))
