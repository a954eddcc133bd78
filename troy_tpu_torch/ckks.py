"""CKKSEncoder: canonical-embedding encoding of complex vectors.

The port of troy_tpu/ckks.py. The n/2 complex slots map onto the odd powers
of the 2n-th root of unity zeta through the 3^i orbit (so slot rotations
are the Galois automorphisms of the batch encoder), conjugate symmetry
makes the inverse embedding real, and the coefficients are scaled, rounded
exactly and decomposed into RNS.

On the context's device, encode is kernel O1 (the FP64 transform with the
slot scatter fused in), O2 (untwist, scale, round, reduce into every prime)
and A (the NTT); decode is A (inverse NTT), O3 (the centred CRT composition
times 1/scale) and O1 (the transform with the twist and the slot gather
fused in); where the transforms are A's, O2's rounding runs in A's first
pass (AO2p). ``encode_with_stats`` runs AO4p in AO2p's place (O4 in O2's
off A's route), which also reduces the largest rounded coefficient
(troy's gMaxReal) to a device scalar; an
``encode`` whose host bound scale * max|v| reaches Q/2 runs it and reads it
back, troy's exact magnitude check. ``decode_device_with_stats`` runs O5 in
O1's place, which also reduces the conjugate-symmetry residual of the
transform. ``encode_device`` and ``decode_device`` take and give device
tensors. ``encode_polynomial`` and ``decode_polynomial`` take real
coefficients straight through O2 and A, and A and O3 (no embedding).
``host=True`` keeps the JAX package's independent host oracle:
numpy's FFT, exact host rounding and composition, and the port's numpy NTT
(utils/host_ntt.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import native
from .context import ContextData, HeContext
from .he_types import Plaintext
from .interop import to_numpy, to_torch
from .params import SchemeType
from .ops import embedding as emb
from .ops import ntt as dntt
from .ops import u64ops as u
from .utils import host_ntt as hntt


def _round_to_rns(coeffs: np.ndarray, cd: ContextData) -> np.ndarray:
    """Host oracle: round scaled float coefficients and decompose into RNS
    (troy_tpu/ckks.py:37-54): int64 below 2^62 (f64 is exact there up to its
    53-bit mantissa), exact Python integers beyond."""
    n = coeffs.shape[0]
    rns = np.zeros((cd.limbs, n), dtype=np.uint64)
    if np.max(np.abs(coeffs), initial=0.0) < 2.0 ** 62:
        ints = np.rint(coeffs).astype(np.int64)
        for i, q in enumerate(cd.coeff_values):
            rns[i] = (ints % np.int64(q)).astype(np.uint64)
        return rns
    exact = [int(round(float(c))) for c in coeffs]
    for i, q in enumerate(cd.coeff_values):
        rns[i] = np.array([c % q for c in exact], dtype=np.uint64)
    return rns


@dataclass(frozen=True)
class EncodeStats:
    """The largest |coefficient| of an encode, as troy's gMaxReal
    (ckks_cuda.cu:178-209, :386-407) and the JAX package's EncodeStats
    (troy_tpu/ckks.py:58): max_abs_small times 2^exponent.

    ``max_abs_small`` is a 0-d float64 tensor on the context's device (or a
    float); the properties read it back. The port rounds at the full scale
    (kernels AO4p and O4), so its exponent is 0 where the JAX package
    splits the scale."""

    max_abs_small: object
    exponent: int = 0

    @property
    def max_coeff_bit_count(self) -> int:
        """ceil(log2(max|coeff|)) + 1 (ckks_cuda.cu:404)."""
        m = float(self.max_abs_small)
        bits = math.ceil(math.log2(m)) if m > 1.0 else 0
        return bits + self.exponent + 1

    @property
    def max_coeff_log2(self) -> float:
        m = float(self.max_abs_small)
        return (math.log2(m) if m > 0 else 0.0) + self.exponent


class CKKSEncoder:
    """(ckks.h:97)"""

    def __init__(self, context: HeContext, host: bool = False):
        if context.scheme != SchemeType.ckks:
            raise ValueError("CKKSEncoder requires a CKKS context")
        self.context = context
        self.n = context.n
        self.slots = self.n // 2
        self.host = host
        self._slot_index, self._twist, self._untwist = (
            emb.host_embed_tables(self.n))
        self._emb = None if host else emb.make_embed_tables(self.n,
                                                            context.device)

    @property
    def slot_count(self) -> int:
        return self.slots

    def _level(self, level: Optional[int]) -> int:
        return self.context.first_level if level is None else level

    def _coeffs_host(self, values: np.ndarray, scale: float) -> np.ndarray:
        """The scaled real coefficients by numpy's FFT (the oracle)."""
        n = self.n
        v = np.zeros(n, dtype=np.complex128)
        j = self._slot_index[:len(values)]
        v[j] = values
        v[n - 1 - j] = np.conj(values)
        u = np.fft.fft(v) / n
        return (u * self._untwist).real * scale

    def encode(self, values: Union[Sequence[complex], np.ndarray],
               scale: float, level: Optional[int] = None) -> Plaintext:
        """Slot values (at most n/2) -> NTT-form plaintext at ``level``
        (default: the first data level) with ``scale``."""
        level = self._level(level)
        cd = self.context.get_context_data(level)
        values = np.asarray(values, dtype=np.complex128)
        if values.ndim != 1 or len(values) > self.slots:
            raise ValueError("too many slot values")
        if self.host:
            return self._encode_host(values, scale, level, cd)
        # the host bound of troy_tpu/ckks.py:134-149: |coeffs| <= scale *
        # max|values|, with no readback; only where it fails does the exact
        # check run: the statistic of O4, read back
        bound = float(scale) * float(np.max(np.abs(values), initial=0.0))
        if bound >= cd.total_coeff_modulus / 2:
            plain, stats = self.encode_with_stats(values, scale, level)
            if stats.max_coeff_bit_count >= \
                    cd.total_coeff_modulus.bit_length():
                raise ValueError("encoded values are too large for the "
                                 "coefficient modulus at this level")
            return plain
        return self._encode_device(torch.from_numpy(values).to(cd.device),
                                   scale, level, cd)

    def _encode_device(self, values: torch.Tensor, scale: float, level: int,
                       cd: ContextData, stats: bool = False):
        """O1, then O2's rounding and A's forward transform on complex slot
        values on the device: one AO2p call (O2 in A's first pass) where
        the transforms are A's, O2 and J otherwise; with ``stats`` one AO4p
        call (AO2p with O4's statistic) where the transforms are A's, O4
        and J otherwise. The plaintext, or (plaintext, EncodeStats)."""
        u = emb.embed_inverse_fft(values, self._emb)
        rt = emb.make_rns_round_tables(cd.ntt)
        if stats and dntt.on_a_route(cd.ntt):
            data, largest = emb.rns_ntt_forward_round_stats(
                u, self._emb.untwist, scale, rt, cd.ntt)
        elif stats:
            rns, largest = emb.untwist_round_to_rns_stats(u, scale,
                                                          self._emb, rt)
            data = dntt.rns_ntt_forward(rns, cd.ntt)
        elif dntt.on_a_route(cd.ntt):
            data = emb.rns_ntt_forward_round(u, self._emb.untwist, scale, rt,
                                             cd.ntt)
        else:
            data = dntt.rns_ntt_forward(
                emb.untwist_round_to_rns(u, scale, self._emb, rt), cd.ntt)
        plain = Plaintext(data=data, level=level, is_ntt_form=True,
                          scale=scale)
        return (plain, EncodeStats(max_abs_small=largest)) if stats \
            else plain

    def encode_device(self, values_re: torch.Tensor,
                      values_im: torch.Tensor, scale: float, max_abs: float,
                      level: Optional[int] = None) -> Plaintext:
        """Slot values already on the device as float64 (re, im) tensors
        (troy_tpu/ckks.py:153): no upload and no readback. ``max_abs`` is a
        host bound on max|values|; this raises where scale * max_abs reaches
        Q/2, as the JAX package does (the exact check would read the
        statistic back)."""
        if self.host:
            raise ValueError("encode_device requires the device encoder")
        level = self._level(level)
        cd = self.context.get_context_data(level)
        if values_re.dim() != 1 or values_re.shape != values_im.shape or \
                values_re.shape[0] > self.slots:
            raise ValueError(f"encode_device: expected two (m <= "
                             f"{self.slots},) tensors, got "
                             f"{tuple(values_re.shape)} and "
                             f"{tuple(values_im.shape)}")
        if float(scale) * float(max_abs) >= cd.total_coeff_modulus / 2:
            raise ValueError("encoded values are too large for the "
                             "coefficient modulus at this level")
        return self._encode_device(torch.complex(values_re, values_im),
                                   scale, level, cd)

    def _encode_host(self, values: np.ndarray, scale: float, level: int,
                     cd: ContextData) -> Plaintext:
        coeffs = self._coeffs_host(values, scale)
        if np.max(np.abs(coeffs), initial=0.0) >= cd.total_coeff_modulus / 2:
            raise ValueError("encoded values are too large for the "
                             "coefficient modulus at this level")
        rns = hntt.rns_ntt_forward_np(_round_to_rns(coeffs, cd), self.n,
                                      cd.coeff_values)
        return Plaintext(data=to_torch(rns, cd.device), level=level,
                         is_ntt_form=True, scale=scale)

    def encode_constant(self, value: Union[float, complex], scale: float,
                        level: Optional[int] = None) -> Plaintext:
        """One number in every slot: the constant polynomial round(value *
        scale), transformed (troy_tpu/ckks.py:242)."""
        if isinstance(value, complex) and value.imag != 0:
            return self.encode(np.full(self.slots, value), scale, level)
        level = self._level(level)
        cd = self.context.get_context_data(level)
        v = int(round(float(value.real if isinstance(value, complex)
                            else value) * scale))
        if abs(v) >= cd.total_coeff_modulus / 2:
            raise ValueError("value too large")
        rns = np.zeros((cd.limbs, self.n), dtype=np.uint64)
        rns[:, 0] = [v % q for q in cd.coeff_values]
        return Plaintext(
            data=dntt.rns_ntt_forward(to_torch(rns, cd.device), cd.ntt),
            level=level, is_ntt_form=True, scale=scale)

    def encode_int64(self, value: int,
                     level: Optional[int] = None) -> Plaintext:
        """An integer constant at scale 1 (troy_tpu/ckks.py:263)."""
        return self.encode_constant(float(value), 1.0, level)

    def encode_with_stats(self, values: Union[Sequence[complex], np.ndarray],
                          scale: float, level: Optional[int] = None
                          ) -> Tuple[Plaintext, EncodeStats]:
        """``encode`` and the largest |coefficient| it rounded
        (troy_tpu/ckks.py:187): O1 and AO4p (O4 and J off A's route), the
        statistic a device scalar that stays there until a property of the
        EncodeStats reads it. No magnitude check: this is what the check
        reads. ``host=True``: the host oracle's coefficients."""
        level = self._level(level)
        cd = self.context.get_context_data(level)
        values = np.asarray(values, dtype=np.complex128)
        if values.ndim != 1 or len(values) > self.slots:
            raise ValueError("too many slot values")
        if self.host:
            plain = self._encode_host(values, scale, level, cd)
            m = float(np.max(np.abs(np.rint(self._coeffs_host(values,
                                                               scale))),
                             initial=0.0))
            return plain, EncodeStats(max_abs_small=m)
        return self._encode_device(torch.from_numpy(values).to(cd.device),
                                   scale, level, cd, stats=True)

    def encode_polynomial(self, coeffs: Union[Sequence[float], np.ndarray],
                          scale: float, level: Optional[int] = None
                          ) -> Plaintext:
        """Real coefficients (at most n) times ``scale``, rounded half to
        even into every prime and transformed: an NTT-form plaintext at
        ``level`` (troy_tpu/ckks.py:269, ckks_cuda.cu:455). On the device
        O2's rounding of the float64 words and A's forward transform
        (troy_tpu/ops/embedding.py:601 encode_polynomial_pipeline): one
        AO2p call where the transforms are A's, O2 (with a unit untwist)
        and J otherwise; the rounding is exact at any magnitude, where the
        JAX package's device encode splits the scale above 2^44 (ROADMAP
        queue 3)."""
        level = self._level(level)
        cd = self.context.get_context_data(level)
        coeffs = np.asarray(coeffs, dtype=np.float64)
        if coeffs.ndim != 1 or len(coeffs) > self.n:
            raise ValueError("too many coefficients")
        scaled = np.zeros(self.n, dtype=np.float64)
        scaled[:len(coeffs)] = coeffs
        if np.max(np.abs(scaled), initial=0.0) * float(scale) \
                >= cd.total_coeff_modulus / 2:
            raise ValueError("encoded values are too large for the "
                             "coefficient modulus at this level")
        if self.host:
            rns = hntt.rns_ntt_forward_np(_round_to_rns(scaled * scale, cd),
                                          self.n, cd.coeff_values)
            return Plaintext(data=to_torch(rns, cd.device), level=level,
                             is_ntt_form=True, scale=scale)
        coeffs_dev = torch.from_numpy(scaled).to(cd.device)
        rt = emb.make_rns_round_tables(cd.ntt)
        if dntt.on_a_route(cd.ntt):
            data = emb.rns_ntt_forward_round(coeffs_dev, None, scale, rt,
                                             cd.ntt)
        else:
            data = dntt.rns_ntt_forward(
                emb.round_to_rns(coeffs_dev, scale, rt), cd.ntt)
        return Plaintext(data=data, level=level, is_ntt_form=True,
                         scale=scale)

    def decode(self, plain: Plaintext) -> np.ndarray:
        """Slot values (n/2,) complex128, read back to the host."""
        if not plain.is_ntt_form or plain.level is None:
            raise ValueError("CKKS decode expects an NTT-form plaintext")
        cd = self.context.get_context_data(plain.level)
        if self.host:
            coeffs = self._compose_centered_host(plain, cd) / plain.scale
            v = np.fft.ifft(coeffs * self._twist) * self.n
            return v[self._slot_index]
        return emb.embed_forward(self._decode_coeffs(plain, cd),
                                 self._emb).cpu().numpy()

    def _decode_coeffs(self, plain: Plaintext,
                       cd: ContextData) -> torch.Tensor:
        """A (inverse) and O3: the centred coefficients times 1/scale, (n,)
        float64 on the device (a plaintext held on the host, as
        ``Decryptor.decrypt_many`` returns them, moved there first)."""
        residues = dntt.rns_ntt_inverse(plain.data.to(cd.device), cd.ntt)
        return emb.compose_centered(residues,
                                    emb.make_rns_round_tables(cd.ntt),
                                    1.0 / plain.scale)

    def _device_cd(self, plain: Plaintext, what: str) -> ContextData:
        if self.host:
            raise ValueError(f"{what} requires the device encoder")
        if not plain.is_ntt_form or plain.level is None:
            raise ValueError("CKKS decode expects an NTT-form plaintext")
        return self.context.get_context_data(plain.level)

    def decode_device(self, plain: Plaintext
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Slot values as (re, im) float64 tensors (n/2,) on the device, no
        readback (troy_tpu/ckks.py:329): A, O3 and O1."""
        cd = self._device_cd(plain, "decode_device")
        v = emb.embed_forward(self._decode_coeffs(plain, cd), self._emb)
        return v.real, v.imag

    def decode_device_with_stats(self, plain: Plaintext):
        """``decode_device`` and the conjugate-symmetry residual of the
        transform, a 0-d float64 tensor on the device: (re, im, max_err),
        no readback (troy_tpu/ckks.py:339). A, O3 and O5; the slots are
        ``decode_device``'s bit for bit."""
        cd = self._device_cd(plain, "decode_device_with_stats")
        v, _, err = emb.embed_forward_stats(self._decode_coeffs(plain, cd),
                                            self._emb)
        return v.real, v.imag, err

    def decode_max_error(self, plain: Plaintext) -> float:
        """The decode's rounding-error estimate in slot units, read back
        (troy_tpu/ckks.py:353): O5's residual; ``host=True``, the residual
        of numpy's inverse FFT on the host oracle's coefficients."""
        if not self.host:
            return float(self.decode_device_with_stats(plain)[2])
        cd = self.context.get_context_data(plain.level)
        coeffs = self._compose_centered_host(plain, cd) / plain.scale
        v = np.fft.ifft(coeffs * self._twist) * self.n
        idx = self._slot_index
        conj = np.conj(v[self.n - 1 - idx])
        return float(np.max(np.abs(v[idx] - conj), initial=0.0))

    def decode_polynomial(self, plain: Plaintext,
                          count: Optional[int] = None) -> np.ndarray:
        """The plaintext's centred coefficients times 1/scale, (n,) float64
        on the host, the first ``count`` if given (troy_tpu/ckks.py:383): on
        the device the inverse A and O3 (troy_tpu/ops/embedding.py:664
        decode_polynomial_pipeline). A plaintext held on the host (as
        ``Decryptor.decrypt_many`` returns them) is moved to the context's
        device first."""
        if not plain.is_ntt_form or plain.level is None:
            raise ValueError("CKKS decode expects an NTT-form plaintext")
        cd = self.context.get_context_data(plain.level)
        if self.host:
            coeffs = self._compose_centered_host(plain, cd) / plain.scale
        else:
            residues = dntt.rns_ntt_inverse(plain.data.to(cd.device), cd.ntt)
            coeffs = emb.compose_centered(
                residues, emb.make_rns_round_tables(cd.ntt),
                1.0 / plain.scale).cpu().numpy()
        return coeffs if count is None else coeffs[:count]

    def _compose_centered_host(self, plain: Plaintext,
                               cd: ContextData) -> np.ndarray:
        """RNS -> centred coefficients as f64, in host integers (the
        oracle of troy_tpu/ckks.py:297-326): the native runtime's
        multiword composition when it loads, else Python integers."""
        res = hntt.rns_ntt_inverse_np(to_numpy(plain.data), self.n,
                                      cd.coeff_values)
        Q = cd.total_coeff_modulus
        qs = cd.coeff_values
        punct = [Q // q for q in qs]
        invp = [pow(p % q, -1, q) for p, q in zip(punct, qs)]
        w = (Q.bit_length() + 63) // 64
        words = lambda v: [(v >> (64 * i)) & u.M64 for i in range(w)]
        out = native.crt_compose_centered_double(
            res, qs, invp, [u.shoup_quotient(x, q) for x, q in zip(invp, qs)],
            np.array([words(p) for p in punct], dtype=np.uint64),
            np.array(words(Q), dtype=np.uint64), 1.0)
        if out is not None:
            return out
        acc = np.zeros(self.n, dtype=object)
        for r, q, p, inv in zip(res, qs, punct, invp):
            acc += r.astype(object) * inv % q * p
        acc %= Q
        acc = np.where(acc > Q // 2, acc - Q, acc)
        return acc.astype(np.float64)
