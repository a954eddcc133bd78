"""The CKKS canonical embedding in FP64, the exact f64 <-> RNS conversions
and the statistics of the device encode and decode.

The port of troy_tpu/ops/embedding.py on kernels O1-O5 (csrc/embedding.cu):

  * ``embed_inverse_fft`` (O1, encode): slot values (m <= n/2,) complex ->
    u = FFT(V)/n (n,) complex, V the conjugate-symmetric evaluation vector
    (``scatter_slots``);
  * ``embed_forward`` (O1, decode): real coefficients (n,) -> slot values
    (n/2,) complex, conj-FFT(c * twist) at the slot orbit;
  * ``untwist_round_to_rns`` (O2): round(Re(u * untwist) * scale) mod every
    q_i, (n,) complex -> (k, n) words, exact at any magnitude;
  * ``rns_ntt_forward_round`` (AO2p): O2's rounding (or, with no untwist,
    round(c * scale) of real coefficients) folded into kernel A's first
    forward pass (csrc/ntt.cu), the words of O2 then the forward NTT in
    one call: the encodes' route where the transforms are A's;
  * ``rns_ntt_forward_round_stats`` (AO4p): AO2p's words and O4's
    statistic in the same two launches (the first pass's blocks of one
    limb reduce their largest rounded |value|, the last pass's first
    block the statistic): ``encode_with_stats`` on A's route;
  * ``compose_centered`` (O3): (k, n) residues -> the centred CRT value as
    f64, times 1/scale;
  * ``untwist_round_to_rns_stats`` (O4): O2's words and max |rint(Re(u *
    untwist) * scale)|, the largest rounded coefficient, as a device f64
    scalar (troy_tpu/ops/embedding.py:611 encode_stats_pipeline, troy's
    gMaxReal);
  * ``embed_forward_stats`` (O5): O1 decode's slots, their conjugate
    partners V[n-1-j] and the conjugate-symmetry residual
    max(|Re V[j] - Re V[n-1-j]|, |Im V[j] + Im V[n-1-j]|) over the slots
    (``conj_residual`` of the two), a device f64 scalar
    (troy_tpu/ops/embedding.py:637 decode_stats_pipeline).

The untwist moved from the transform into the rounding kernel, so the JAX
package's ``embed_inverse`` (which returns Re(untwist * FFT(V)/n)) and
``round_to_rns_device`` (which rounds real coefficients) become
``embed_inverse_fft`` and ``untwist_round_to_rns`` here; ``scatter_slots``,
``embed_forward`` and ``compose_centered`` keep their meaning.

The transform is the JAX package's 4-step split n = A x B
(out[p2*A + p1] = sum_b [sum_a x[a, b] w1[p1, a]] tw[p1, b] w2[b, p2]) in
native FP64: the TPU's int8 digit planes (troy_tpu/ops/embedding.py:56-255),
radix-2^32 peeling (:371-436, :443-488) and host scale split (:491) existed
only for its float32-pair f64 emulation and are not ported. The kernel runs
each factor as short FFTs in shared memory (length-A over columns, length-B
over rows) on the tables of ``line_roots``. Each wrapper launches its
kernel for tensors on CUDA and runs its plain version for tensors on the
CPU: O1's plain version is the 4-step schedule in torch.complex128 matrix
products, O2's is the kernel's steps on the int64 u64ops twin and
float64 tensors, O3's the JAX package's (the reduction by k - 1
conditional subtracts, where the kernel subtracts one rounded multiple of
Q; both give the same words, tests/test_torch_compose.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from . import ntt as dntt
from . import u64ops as u
from .. import _kernels
from ..interop import to_torch
from .ntt import RnsNttTables
from .ntt_mxu import _split_factors

C128 = torch.complex128
F64 = torch.float64
# csrc/embedding.cu keeps O3's accumulator in registers and O2's and O3's
# per-limb constants in shared memory
MAX_KERNEL_WORDS = 16
MAX_KERNEL_LIMBS = 64


def slot_index(n: int) -> np.ndarray:
    """Slot i <-> evaluation point zeta^(3^i): natural index (3^i - 1) / 2
    of the length-n transform, (n/2,) int64."""
    idx = np.zeros(n // 2, dtype=np.int64)
    pos = 1
    for i in range(n // 2):
        idx[i] = (pos - 1) >> 1
        pos = (pos * 3) % (2 * n)
    return idx


@lru_cache(maxsize=None)
def host_embed_tables(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(slot_index(n), twist, untwist) as numpy: twist[j] = zeta^j =
    exp(i pi j / n), untwist its conjugate. The one source of the slot orbit
    and the twist, for ``make_embed_tables`` and the encoder's host
    oracle."""
    j = np.arange(n)
    return (slot_index(n), np.exp(1j * np.pi * j / n),
            np.exp(-1j * np.pi * j / n))


@dataclass(eq=False)
class EmbedTables:
    """The constant tables of one degree n = A x B on one device.

    Encode direction (numpy's FFT sign): w1e[p1, a] = w^(B p1 a),
    twe[p1, b] = w^(p1 b), w2e[b, p2] = w^(A b p2), w = exp(-2 pi i / n),
    and the kernel's round-major root tables of the length-A and length-B
    FFTs, roots_ae = line_roots(A, B, n) and roots_be = line_roots(B, A, n);
    decode direction: their conjugates. twist[j] = zeta^j = exp(i pi j / n),
    untwist its conjugate. ``scatter[j]`` is i where V[j] = v_i, that is
    j = (3^i - 1) / 2, and ~i where V[j] = conj(v_i), j = n - 1 - (3^i - 1)
    / 2 (the slots and their partners are the n positions): the encode
    scatters through it, the decode stores its slots (and O5 their
    partners) through it.
    """

    n: int
    a: int
    b: int
    w1e: torch.Tensor           # (A, A) complex128
    twe: torch.Tensor           # (A, B)
    w2e: torch.Tensor           # (B, B)
    w1d: torch.Tensor
    twd: torch.Tensor
    w2d: torch.Tensor
    roots_ae: torch.Tensor      # (max(A - 1, 1),) complex128
    roots_be: torch.Tensor      # (max(B - 1, 1),)
    roots_ad: torch.Tensor
    roots_bd: torch.Tensor
    twist: torch.Tensor         # (n,) complex128
    untwist: torch.Tensor
    slot_index: torch.Tensor    # (n/2,) int64
    scatter: torch.Tensor       # (n,) int32

    @property
    def device(self) -> torch.device:
        return self.twist.device


def _omk(k, n: int) -> np.ndarray:
    """w^k, w = exp(-2 pi i / n), the exponent reduced mod n before
    exponentiation, as the JAX package does: w**k for k ~ n A would lose
    angle accuracy."""
    return np.exp(-2j * np.pi * (np.asarray(k) % n) / n)


def line_roots(length: int, stride: int, n: int) -> np.ndarray:
    """The roots of the kernel's radix-2 decimation-in-frequency FFTs of
    ``length`` words with root W = w^stride (length * stride = n), round
    by round: round r's length / 2^(r+1) roots W^(j 2^r) from entry
    length - length / 2^r, (max(length - 1, 1),) complex128 (round r joins
    the words length / 2^(r+1) apart and multiplies their difference by
    root j of its run, j the index mod length / 2^(r+1))."""
    log = length.bit_length() - 1
    e = [(j << r) * stride for r in range(log)
         for j in range(length >> (r + 1))]
    return _omk(e, n) if e else np.ones(1, dtype=np.complex128)


@lru_cache(maxsize=None)
def make_embed_tables(n: int, device) -> EmbedTables:
    A, B = _split_factors(n)
    omk = lambda k: _omk(k, n)
    a_idx, b_idx = np.arange(A), np.arange(B)
    w1 = omk(B * np.outer(a_idx, a_idx))
    tw = omk(np.outer(a_idx, b_idx))
    w2 = omk(A * np.outer(b_idx, b_idx))
    idx, twist, untwist = host_embed_tables(n)
    scatter = np.zeros(n, dtype=np.int32)
    scatter[idx] = np.arange(n // 2)
    scatter[n - 1 - idx] = ~np.arange(n // 2)
    ra, rb = line_roots(A, B, n), line_roots(B, A, n)
    dev = lambda m: torch.from_numpy(np.array(m)).to(device)
    return EmbedTables(
        n=n, a=A, b=B, w1e=dev(w1), twe=dev(tw), w2e=dev(w2),
        w1d=dev(np.conj(w1)), twd=dev(np.conj(tw)), w2d=dev(np.conj(w2)),
        roots_ae=dev(ra), roots_be=dev(rb), roots_ad=dev(np.conj(ra)),
        roots_bd=dev(np.conj(rb)), twist=dev(twist), untwist=dev(untwist),
        slot_index=dev(idx), scatter=dev(scatter))


@dataclass(eq=False)
class RnsRoundTables:
    """Per-level constants of O2 and O3, as csrc/embedding.cu reads them.

    ``round_consts``: q (k), the high Barrett words (k), 2^e mod q_i
    (k x E) and their Shoup words (k x E), e < E = max(1, bits(Q) - 52):
    a rounded coefficient |v| < 2^bits(Q) is m 2^e with m < 2^53.
    ``compose_consts``: q (k), invp_i = (Q/q_i)^-1 mod q_i (k), their Shoup
    words (k), the punctured products Q/q_i (k x W words), Q (W words),
    (Q + 1)/2 (W words), words little-endian, W = words(Q) + 1 (one for
    carries), then 1/q_i rounded to f64, as bit patterns (k; O3's estimate
    of the multiple of Q)."""

    q_values: Tuple[int, ...]
    round_consts: torch.Tensor
    exponents: int              # E
    compose_consts: torch.Tensor
    words: int                  # W
    punct: Tuple[int, ...]
    total: int                  # Q


def _to_words(v: int, count: int) -> list:
    return [(v >> (64 * i)) & u.M64 for i in range(count)]


def make_rns_round_tables(t: RnsNttTables) -> RnsRoundTables:
    """The tables of the base of t, made once per tables object."""
    key = ("ckks_round",)
    if key not in t._memo:
        qv = t.values
        k = len(qv)
        Q = 1
        for q in qv:
            Q *= q
        E = max(1, Q.bit_length() - 52)
        W = (Q.bit_length() + 63) // 64 + 1
        pow2 = [pow(2, e, q) for q in qv for e in range(E)]
        pow2_shoup = [u.shoup_quotient(w, q)
                      for w, q in zip(pow2, [q for q in qv for _ in range(E)])]
        ratio = [((1 << 128) // q) >> 64 for q in qv]
        punct = tuple(Q // q for q in qv)
        invp = [pow(p % q, -1, q) for p, q in zip(punct, qv)]
        words = lambda w: to_torch(np.array(w, dtype=np.uint64), t.device)
        compose = (list(qv) + invp
                   + [u.shoup_quotient(w, q) for w, q in zip(invp, qv)]
                   + [x for p in punct for x in _to_words(p, W)]
                   + _to_words(Q, W) + _to_words((Q + 1) // 2, W)
                   + [int(np.float64(1 / q).view(np.uint64)) for q in qv])
        t._memo[key] = RnsRoundTables(
            q_values=qv,
            round_consts=words(list(qv) + ratio + pow2 + pow2_shoup),
            exponents=E, compose_consts=words(compose), words=W,
            punct=punct, total=Q)
    return t._memo[key]


# --------------------------------------------------------------------------
# plain versions (the CPU path; on the card, the kernels' comparison)
# --------------------------------------------------------------------------

def scatter_slots(values: torch.Tensor, t: EmbedTables) -> torch.Tensor:
    """Slot values (m <= n/2,) -> the conjugate-symmetric evaluation vector
    (n,): V[idx_i] = v_i, V[n-1-idx_i] = conj(v_i), 0 elsewhere."""
    m = values.shape[0]
    idx = t.slot_index[:m]
    v = torch.zeros(t.n, dtype=C128, device=values.device)
    v[idx] = values
    v[t.n - 1 - idx] = values.conj()
    return v


def _four_step_plain(x: torch.Tensor, w1: torch.Tensor, tw: torch.Tensor,
                     w2: torch.Tensor, t: EmbedTables) -> torch.Tensor:
    """out[p2*A + p1] = sum_b [sum_a w1[p1, a] x[a, b]] tw[p1, b] w2[b, p2]."""
    s = (w1 @ x.reshape(t.a, t.b)) * tw
    return (s @ w2).T.reshape(t.n)


def embed_inverse_fft_plain(values: torch.Tensor,
                            t: EmbedTables) -> torch.Tensor:
    """The plain version of O1's encode direction: FFT(V)/n."""
    return _four_step_plain(scatter_slots(values, t), t.w1e, t.twe, t.w2e,
                            t) * (1.0 / t.n)


def embed_forward_plain(coeffs: torch.Tensor, t: EmbedTables) -> torch.Tensor:
    """The plain version of O1's decode direction: conj-FFT(c twist) at the
    slot orbit."""
    v = _four_step_plain(coeffs * t.twist, t.w1d, t.twd, t.w2d, t)
    return v[t.slot_index]


def conj_residual(slots: torch.Tensor,
                  partners: torch.Tensor) -> torch.Tensor:
    """max(|Re v_j - Re p_j|, |Im v_j + Im p_j|) over j, v the slots and p
    their conjugate partners V[n-1-idx_j], as a 0-d float64 tensor: O5's
    statistic (exact: a maximum of differences rounded once)."""
    return torch.maximum((slots.real - partners.real).abs().max(),
                         (slots.imag + partners.imag).abs().max())


def embed_forward_stats_plain(coeffs: torch.Tensor, t: EmbedTables):
    """The plain version of O5: (slots (n/2,) complex128, their partners
    (n/2,) complex128, the residual as a 0-d float64 tensor)."""
    v = _four_step_plain(coeffs * t.twist, t.w1d, t.twd, t.w2d, t)
    slots, partners = v[t.slot_index], v[t.n - 1 - t.slot_index]
    return slots, partners, conj_residual(slots, partners)


def _pow2_neg(e: torch.Tensor) -> torch.Tensor:
    """2^-e as float64 for integer 0 <= e < 1023, built from its bits."""
    return ((1023 - e) << 52).view(F64)


def untwist_round_to_rns_plain(u_: torch.Tensor,
                               untwist: Optional[torch.Tensor], scale: float,
                               rt: RnsRoundTables) -> torch.Tensor:
    """The plain version of O2: (n,) complex -> (k, n) words; with no
    untwist, (n,) float64 real coefficients rounded as they are (the words
    of a unit untwist: Re(c * 1) = c)."""
    k, E = len(rt.q_values), rt.exponents
    c = rt.round_consts
    q = c[:k].reshape(k, 1)
    ratio = c[k:2 * k].reshape(k, 1)
    pow2 = c[2 * k:2 * k + k * E].reshape(k, E)
    pow2_shoup = c[2 * k + k * E:].reshape(k, E)
    re = u_ if untwist is None \
        else u_.real * untwist.real - u_.imag * untwist.imag
    v = torch.round(re * scale)                   # half to even
    neg = v < 0
    a = v.abs()
    _, ex = torch.frexp(a)
    e = (ex.to(torch.int64) - 53).clamp(0, E - 1)
    m = (a * _pow2_neg(e)).to(torch.int64)        # exact, < 2^53
    r = u.barrett_reduce_64(m, q, ratio)
    r = u.mul_mod_shoup(r, pow2[:, e], pow2_shoup[:, e], q)
    return torch.where(neg, u.neg_mod(r, q), r)


def round_stats_plain(u_: torch.Tensor, untwist: Optional[torch.Tensor],
                      scale: float) -> torch.Tensor:
    """The statistic of O4 in plain PyTorch: max |rint(Re(u * untwist) *
    scale)| (with no untwist, max |rint(u * scale)| of real words) as a 0-d
    float64 tensor, from O2's own rounded values."""
    re = u_ if untwist is None \
        else u_.real * untwist.real - u_.imag * untwist.imag
    return torch.round(re * scale).abs().max()


def compose_centered_plain(residues: torch.Tensor, rt: RnsRoundTables,
                           inv_scale: float = 1.0) -> torch.Tensor:
    """The plain version of O3 (troy_tpu/ops/embedding.py:550
    compose_centered_device, times inv_scale): v = sum_i (r_i invp_i mod q_i)
    P_i in W u64 words, reduced mod Q, centred, converted top-down to f64."""
    k, W = len(rt.q_values), rt.words
    c = rt.compose_consts
    q, invp, invp_shoup = (c[i * k:(i + 1) * k].reshape(k, 1)
                           for i in range(3))
    q_words = _to_words(rt.total, W)
    qhalf_words = _to_words((rt.total + 1) // 2, W)
    ult = lambda a, b: u.ult(a, b).to(torch.int64)
    x_all = u.mul_mod_shoup(residues, invp, invp_shoup, q)
    zero = torch.zeros_like(residues[0])
    acc = [zero] * W
    for i in range(k):
        x = x_all[i]
        carry = zero
        out = []
        for w, pw in enumerate(_to_words(rt.punct[i], W)):
            lo, hi = u.mul128(x, pw)
            s1 = acc[w] + lo
            c1 = ult(s1, lo)
            s2 = s1 + carry
            c2 = ult(s2, carry)
            out.append(s2)
            carry = hi + c1 + c2
        acc = out
    for _ in range(k - 1):
        borrow = zero
        diff = []
        for w, cw in enumerate(q_words):
            cw = u.s64(cw)
            d1 = acc[w] - cw
            b1 = ult(acc[w], cw)
            diff.append(d1 - borrow)
            borrow = b1 + ult(d1, borrow)
        keep = borrow != 0
        acc = [torch.where(keep, a, d) for a, d in zip(acc, diff)]
    borrow = zero
    for w, cw in enumerate(qhalf_words):
        cw = u.s64(cw)
        d1 = acc[w] - cw
        borrow = ult(acc[w], cw) + ult(d1, borrow)
    neg = borrow == 0
    borrow = zero
    mag = []
    for w, cw in enumerate(q_words):
        cw = u.s64(cw)
        d1 = cw - acc[w]
        b1 = ult(cw, acc[w])
        mag.append(d1 - borrow)
        borrow = b1 + ult(d1, borrow)
    vals = [torch.where(neg, m, a) for m, a in zip(mag, acc)]
    f = torch.zeros(residues.shape[1:], dtype=F64, device=residues.device)
    for w in reversed(range(W)):
        hi = u.shr(vals[w], 32).to(F64)
        lo = (vals[w] & 0xFFFFFFFF).to(F64)
        f = f * (2.0 ** 64) + hi * (2.0 ** 32) + lo
    return torch.where(neg, -f, f) * inv_scale


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def launch_geometry(t: EmbedTables) -> Tuple[Tuple[int, int], ...]:
    """(blocks, threads) of each of O1's two launches at t's split, the
    columns pass then the rows pass (the card's library); () for a split
    the kernel refuses."""
    geometry = (ctypes.c_longlong * 4)()
    _kernels.library()
    count = _kernels._entries["troy_ckks_fft_geometry"](
        t.a, t.b, ctypes.addressof(geometry))
    return tuple((geometry[2 * i], geometry[2 * i + 1])
                 for i in range(count))


def embed_inverse_fft(values: torch.Tensor, t: EmbedTables) -> torch.Tensor:
    """O1, encode: slot values (m <= n/2,) complex128 -> FFT(V)/n, (n,)
    complex128 (the untwist follows in O2)."""
    if values.dim() != 1 or values.shape[0] > t.n // 2:
        raise ValueError(f"embed_inverse_fft: expected at most {t.n // 2} "
                         f"slot values, got {tuple(values.shape)}")
    if values.dtype != C128:
        raise TypeError(f"embed_inverse_fft: expected complex128, got "
                        f"{values.dtype}")
    if not _kernels.on_cuda(values, t.twist):
        return embed_inverse_fft_plain(values, t)
    values = values.contiguous()
    _kernels.check_operand(values, "embed_inverse_fft values", C128)
    out = torch.empty(t.n, dtype=C128, device=values.device)
    scratch = torch.empty_like(out)
    _kernels.launch("troy_ckks_fft_encode", out.get_device(), out, values,
                    scratch, t.scatter, values.shape[0], t.roots_ae, t.twe,
                    t.roots_be, t.a, t.b, 1.0 / t.n)
    return out


def _check_coeffs(coeffs: torch.Tensor, t: EmbedTables, name: str) -> None:
    if coeffs.shape != (t.n,):
        raise ValueError(f"{name}: expected ({t.n},), got "
                         f"{tuple(coeffs.shape)}")
    if coeffs.dtype != F64:
        raise TypeError(f"{name}: expected float64, got {coeffs.dtype}")


def embed_forward(coeffs: torch.Tensor, t: EmbedTables) -> torch.Tensor:
    """O1, decode: real coefficients (n,) float64 -> slot values (n/2,)
    complex128."""
    _check_coeffs(coeffs, t, "embed_forward")
    if not _kernels.on_cuda(coeffs, t.twist):
        return embed_forward_plain(coeffs, t)
    coeffs = coeffs.contiguous()
    _kernels.check_operand(coeffs, "embed_forward coeffs", F64)
    out = torch.empty(t.n // 2, dtype=C128, device=coeffs.device)
    scratch = torch.empty(t.n, dtype=C128, device=coeffs.device)
    _kernels.launch("troy_ckks_fft_decode", out.get_device(), out, coeffs,
                    scratch, t.scatter, t.twist, t.roots_ad, t.twd,
                    t.roots_bd, t.a, t.b)
    return out


def embed_forward_stats(coeffs: torch.Tensor, t: EmbedTables):
    """O5: ``embed_forward``'s slot values (bit for bit), their conjugate
    partners V[n-1-idx_j] and the conjugate-symmetry residual of the two
    (``conj_residual``), a 0-d float64 tensor on the coefficients' device.
    The coefficients are real, so V[n-1-j] = conj(V[j]) in exact
    arithmetic: the residual measures the transform's rounding in slot
    units."""
    _check_coeffs(coeffs, t, "embed_forward_stats")
    if not _kernels.on_cuda(coeffs, t.twist):
        return embed_forward_stats_plain(coeffs, t)
    coeffs = coeffs.contiguous()
    _kernels.check_operand(coeffs, "embed_forward_stats coeffs", F64)
    out = torch.empty(t.n // 2, dtype=C128, device=coeffs.device)
    partner = torch.empty_like(out)
    err = torch.empty((), dtype=F64, device=coeffs.device)
    scratch = torch.empty(t.n, dtype=C128, device=coeffs.device)
    _kernels.launch("troy_ckks_fft_decode_stats", out.get_device(), out,
                    partner, err, coeffs, scratch, t.scatter, t.twist,
                    t.roots_ad, t.twd, t.roots_bd, t.a, t.b)
    return out, partner, err


def untwist_round_to_rns(u_: torch.Tensor, scale: float, t: EmbedTables,
                         rt: RnsRoundTables) -> torch.Tensor:
    """O2: u (n,) complex128 -> round(Re(u * untwist) * scale) mod q_i,
    (k, n) words, round half to even, exact while |round(...)| <
    2^bits(Q) (the encoder checks the magnitude first)."""
    if u_.shape != (t.n,):
        raise ValueError(f"untwist_round_to_rns: expected ({t.n},), got "
                         f"{tuple(u_.shape)}")
    return _round(u_, t.untwist, scale, rt, "untwist_round_to_rns")


def untwist_round_to_rns_stats(u_: torch.Tensor, scale: float,
                               t: EmbedTables, rt: RnsRoundTables):
    """O4: O2's words, and the largest |rounded coefficient| max
    |rint(Re(u * untwist) * scale)| as a 0-d float64 tensor on u's device,
    in the same launch. rint is odd and monotone, so this is the JAX
    package's max |rint(c s)| with the scale unsplit (its exponent is 0
    here): troy's gMaxReal, which the encoder's exact magnitude check
    reads."""
    if u_.shape != (t.n,):
        raise ValueError(f"untwist_round_to_rns_stats: expected ({t.n},), "
                         f"got {tuple(u_.shape)}")
    return _round(u_, t.untwist, scale, rt, "untwist_round_to_rns_stats",
                  stats=True)


@lru_cache(maxsize=None)
def _unit_untwist(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=C128, device=device)


def round_to_rns(coeffs: torch.Tensor, scale: float,
                 rt: RnsRoundTables) -> torch.Tensor:
    """O2 on real coefficients (n,) float64: round(c * scale) mod q_i, (k,
    n) words, with a unit untwist (Re(c * 1) = c exactly): the rounding of
    troy_tpu/ops/embedding.py:601 encode_polynomial_pipeline, exact at any
    magnitude below 2^bits(Q)."""
    if coeffs.dim() != 1 or coeffs.dtype != F64:
        raise ValueError(f"round_to_rns: expected (n,) float64, got "
                         f"{tuple(coeffs.shape)} {coeffs.dtype}")
    u_ = coeffs.to(C128)
    return _round(u_, _unit_untwist(coeffs.shape[0], coeffs.device), scale,
                  rt, "round_to_rns")


def _round(u_: torch.Tensor, untwist: torch.Tensor, scale: float,
           rt: RnsRoundTables, name: str, stats: bool = False):
    """O2, or with ``stats`` O4: (words, statistic)."""
    if u_.dtype != C128:
        raise TypeError(f"{name}: expected complex128, got {u_.dtype}")
    if not _kernels.on_cuda(u_, rt.round_consts, untwist):
        words = untwist_round_to_rns_plain(u_, untwist, scale, rt)
        return (words, round_stats_plain(u_, untwist, scale)) if stats \
            else words
    k, n = len(rt.q_values), u_.shape[0]
    if k > MAX_KERNEL_LIMBS:
        raise ValueError(f"{name}: {k} limbs; the kernel takes at most "
                         f"{MAX_KERNEL_LIMBS}")
    u_ = u_.contiguous()
    _kernels.check_operand(u_, f"{name} input", C128)
    out = torch.empty((k, n), dtype=torch.int64, device=u_.device)
    args = (u_, untwist, float(scale), k, n.bit_length() - 1,
            rt.round_consts, rt.exponents)
    if not stats:
        _kernels.launch("troy_ckks_round", out.get_device(), out, *args)
        return out
    stat = torch.empty((), dtype=F64, device=u_.device)
    _kernels.launch("troy_ckks_round_stats", out.get_device(), out, stat,
                    *args)
    return out, stat


def ntt_forward_round_plain(u_: torch.Tensor,
                            untwist: Optional[torch.Tensor], scale: float,
                            rt: RnsRoundTables,
                            tables: RnsNttTables) -> torch.Tensor:
    """The plain version of ``rns_ntt_forward_round``: O2's plain version,
    then the forward butterfly network."""
    return dntt.ntt_forward_plain(
        untwist_round_to_rns_plain(u_, untwist, scale, rt), tables)


def ntt_forward_round_stats_plain(u_: torch.Tensor,
                                  untwist: Optional[torch.Tensor],
                                  scale: float, rt: RnsRoundTables,
                                  tables: RnsNttTables):
    """The plain version of ``rns_ntt_forward_round_stats``: AO2p's plain
    version and O4's statistic's."""
    return (ntt_forward_round_plain(u_, untwist, scale, rt, tables),
            round_stats_plain(u_, untwist, scale))


def _check_round_operands(name: str, u_: torch.Tensor,
                          untwist: Optional[torch.Tensor],
                          rt: RnsRoundTables, tables: RnsNttTables) -> None:
    """AO2p's and AO4p's operands: (n,) words, complex with a complex
    untwist or float64 with none, on A's route, rt of tables' base."""
    want = F64 if untwist is None else C128
    if u_.shape != (tables.n,) or (untwist is not None
                                   and untwist.shape != (tables.n,)):
        raise ValueError(f"{name}: expected ({tables.n},) operands, got "
                         f"{tuple(u_.shape)}"
                         + ("" if untwist is None
                            else f" and {tuple(untwist.shape)}"))
    if u_.dtype != want or (untwist is not None and untwist.dtype != C128):
        raise TypeError(f"{name}: expected {want} words"
                        + ("" if untwist is None else " and a complex128 "
                           "untwist") + f", got {u_.dtype}")
    if not dntt.on_a_route(tables):
        raise ValueError(f"{name}: these tables hold no transform on A "
                         "(kernel J's, or a pointwise view)")
    if tuple(rt.q_values) != tuple(tables.values):
        raise ValueError(f"{name}: the round tables are not of the base of "
                         "these tables")


def rns_ntt_forward_round(u_: torch.Tensor, untwist: Optional[torch.Tensor],
                          scale: float, rt: RnsRoundTables,
                          tables: RnsNttTables) -> torch.Tensor:
    """The CKKS encode's exact rounding, transformed (kernel O2's rounding
    folded into kernel A's first forward pass, AO2p, one A call): u (n,)
    complex128 with its untwist (n,) complex128 (the slot encode), or (n,)
    float64 with none (the polynomial encode's real coefficients) -> (k,
    n), row j the forward NTT of round(Re(u * untwist) * scale), or
    round(u * scale), mod q_j, round half to even, fully reduced: the words
    of ``untwist_round_to_rns`` (or ``round_to_rns``) then
    ``rns_ntt_forward``. rt: the round tables of ``tables``' base. A's
    route only: tables on J, or a pointwise view, raise."""
    name = "rns_ntt_forward_round"
    _check_round_operands(name, u_, untwist, rt, tables)
    operands = [u_, rt.round_consts, tables.q] + (
        [] if untwist is None else [untwist])
    if not _kernels.on_cuda(*operands):
        return ntt_forward_round_plain(u_, untwist, scale, rt, tables)
    u_ = u_.contiguous()
    _kernels.check_operand(u_, f"{name} input", u_.dtype)
    if untwist is not None:
        _kernels.check_operand(untwist, f"{name} untwist", C128)
    out = torch.empty((tables.k, tables.n), dtype=torch.int64,
                      device=u_.device)
    _kernels.launch("troy_ntt_forward_round", out.get_device(), out, u_,
                    untwist, tables.k, tables.log_n, tables.k,
                    tables.root_powers, tables.root_powers_shoup, tables.q,
                    rt.round_consts, rt.exponents, float(scale))
    return out


def rns_ntt_forward_round_stats(u_: torch.Tensor,
                                untwist: Optional[torch.Tensor],
                                scale: float, rt: RnsRoundTables,
                                tables: RnsNttTables):
    """``rns_ntt_forward_round`` and O4's statistic in the same two
    launches (AO4p): (words (k, n), max |rint(Re(u * untwist) * scale)|
    (or |rint(u * scale)|) as a 0-d float64 tensor on u's device). The
    statistic is bit-equal to O4's (a maximum, exact in any order), the
    words to AO2p's. A's route only, as ``rns_ntt_forward_round``."""
    name = "rns_ntt_forward_round_stats"
    _check_round_operands(name, u_, untwist, rt, tables)
    operands = [u_, rt.round_consts, tables.q] + (
        [] if untwist is None else [untwist])
    if not _kernels.on_cuda(*operands):
        return ntt_forward_round_stats_plain(u_, untwist, scale, rt, tables)
    u_ = u_.contiguous()
    _kernels.check_operand(u_, f"{name} input", u_.dtype)
    if untwist is not None:
        _kernels.check_operand(untwist, f"{name} untwist", C128)
    out = torch.empty((tables.k, tables.n), dtype=torch.int64,
                      device=u_.device)
    stat = torch.empty((), dtype=F64, device=u_.device)
    # the first pass's block maxima: at most one a 2^10-word tile of a row
    maxima = torch.empty(max(1, tables.n >> 10), dtype=torch.int64,
                         device=u_.device)
    _kernels.launch("troy_ntt_forward_round_stats", out.get_device(), out,
                    stat, maxima, maxima.numel(), u_, untwist, tables.k,
                    tables.log_n, tables.k, tables.root_powers,
                    tables.root_powers_shoup, tables.q, rt.round_consts,
                    rt.exponents, float(scale))
    return out, stat


def compose_centered(residues: torch.Tensor, rt: RnsRoundTables,
                     inv_scale: float = 1.0) -> torch.Tensor:
    """O3: (k, n) residues -> the centred CRT value times inv_scale, (n,)
    float64."""
    k = len(rt.q_values)
    if residues.dim() != 2 or residues.shape[0] != k:
        raise ValueError(f"compose_centered: expected ({k}, n), got "
                         f"{tuple(residues.shape)}")
    if not _kernels.on_cuda(residues, rt.compose_consts):
        return compose_centered_plain(residues, rt, inv_scale)
    n = residues.shape[1]
    if n & (n - 1) or k > MAX_KERNEL_LIMBS or rt.words > MAX_KERNEL_WORDS:
        raise ValueError(f"compose_centered: n = {n}, k = {k}, "
                         f"{rt.words} words: the kernel takes a power-of-two "
                         f"n, at most {MAX_KERNEL_LIMBS} limbs and "
                         f"{MAX_KERNEL_WORDS} words (Q < 2^"
                         f"{64 * (MAX_KERNEL_WORDS - 1)})")
    residues = residues.contiguous()
    _kernels.check_operand(residues, "compose_centered residues")
    out = torch.empty(n, dtype=F64, device=residues.device)
    _kernels.launch("troy_ckks_compose", out.get_device(), out, residues, k,
                    n.bit_length() - 1, rt.words, rt.compose_consts,
                    float(inv_scale))
    return out
