"""RNS base conversion and the BEHZ tool operations (BFV subset).

The port of troy_tpu/ops/rns.py: ``fast_convert`` (kernel C,
csrc/base_convert.cu), the BFV multiply's lift and tail (kernel E,
csrc/behz.cu: ``behz_lift``, ``behz_tail``), the BFV decrypt rounding
``decrypt_scale_and_round`` (kernel C's conversion q -> {t, gamma}, with
the t gamma premultiply folded into its constants, then kernel E's gamma
correction ``behz_decrypt_round``), and the NTT-domain divide by the last
prime of the CKKS rescale and key switch (kernel K',
csrc/divide_round_ntt.cu, and on A's route folded into kernel A's forward,
csrc/ntt.cu ``ntt_forward_divide``: ``divide_and_round_q_last_ntt``,
``divide_round_last_ntt``), its BGV members, which first subtract a
multiple of t that makes the divided row divisible by the prime
(``mod_t_and_divide_q_last_ntt`` and the BGV key switch's divide, kernel
K'-BGV), the same BGV divide in the coefficient domain
(``mod_t_and_divide_q_last``, kernel K'', csrc/keyswitch.cu), and the BGV
decrypt's exact conversion q -> t
(``exact_convert``, ``decrypt_mod_t``, kernel X, csrc/exact_convert.cu).
On A's route the decrypt's conversions run inside kernel A's last inverse
pass instead (``ntt_inverse_decrypt_mod_t``, AXi, and
``ntt_inverse_decrypt_scale_and_round``, ACi, csrc/ntt.cu; the per-word
arithmetic of X, C and E's rounding shared through csrc/decrypt.cuh);
``decrypt_fused`` picks the route. An RNS polynomial is a (..., k, n) int64
tensor of u64 words; every function here also takes leading batch axes, so
the components of a ciphertext go through in one call.

Each wrapper launches its kernel for tensors on CUDA and runs its plain
version, written on the int64 u64ops twin, for tensors on the CPU. The
plain versions of E are the reference's steps one by one
(``fastbconv_m_tilde_plain``, ``sm_mrq_plain``, ``fast_floor_plain``,
``fastbconv_sk_plain``), composed by ``behz_lift_plain`` and
``behz_tail_plain``.

The host RnsTool (utils/rns.py) holds every constant as Python ints;
``DeviceRnsTool`` packs what these functions need into small tensors on the
context's device once per context level.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from . import ntt as dntt
from . import u64ops as u
from .. import _kernels
from ..interop import to_torch
from ..utils.rns import BaseConverter, RnsBase, RnsTool
from . import keyswitch as dks
from .keyswitch import MAX_KERNEL_LIMBS as KEYSWITCH_MAX_LIMBS
from .ntt import RnsNttTables
from .poly import ADD, SCALAR_MUL, rns_elementwise_plain

# Kernel C keeps a converter's limbs in registers, kernel E a tile's limbs
# in shared memory, both the constants in shared memory: at most this many
# limbs per base, which covers SEAL's n = 32768 chain (16 primes of q;
# |Bsk| = 17 and m~ at the key level).
MAX_KERNEL_LIMBS = 20


def _words(words, device) -> torch.Tensor:
    return to_torch(np.array(words, dtype=np.uint64), device)


def _shoup(scalars, moduli) -> list:
    """[s_i mod q_i ..., their Shoup quotients ...] as the kernels read
    them."""
    w = [s % q for s, q in zip(scalars, moduli)]
    return w + [u.shoup_quotient(s, q) for s, q in zip(w, moduli)]


@dataclass(frozen=True, eq=False)
class DeviceConverter:
    """One base converter's constants, packed as kernel C reads them:
    [q_in, inv_punctured, inv_punctured_shoup (k_in each),
     p_out, cr_lo, cr_hi (k_out each), M (k_out x k_in)]."""

    consts: torch.Tensor
    k_in: int
    k_out: int

    @staticmethod
    def words(conv: BaseConverter, scale=None) -> list:
        """The layout above; ``scale`` (one word per input limb) folds a
        premultiply into the inverse punctured products: converting x with
        them gives the words of converting x * scale_i mod q_i, since both
        Shoup products are fully reduced."""
        ib, ob = conv.ibase, conv.obase
        if scale is None:
            invp = list(conv.inv_punctured)
            invp_shoup = list(conv.inv_punctured_shoup)
        else:
            invp = [s * p % q for s, p, q in zip(scale, conv.inv_punctured,
                                                 ib.values)]
            invp_shoup = [u.shoup_quotient(p, q)
                          for p, q in zip(invp, ib.values)]
        return (list(ib.values) + invp + invp_shoup + list(ob.values)
                + [m.const_ratio[0] for m in ob.moduli]
                + [m.const_ratio[1] for m in ob.moduli]
                + [x for row in conv.matrix for x in row])

    @classmethod
    def build(cls, conv: BaseConverter, device,
              scale=None) -> "DeviceConverter":
        return cls(_words(cls.words(conv, scale), device), conv.ibase.size,
                   conv.obase.size)

    def parts(self):
        """(q_in, invp, invp_shoup, p_out, cr_lo, cr_hi, M) views."""
        ki, ko = self.k_in, self.k_out
        c = self.consts
        sizes = [ki, ki, ki, ko, ko, ko, ko * ki]
        out = list(torch.split(c, sizes))
        out[6] = out[6].reshape(ko, ki)
        return out


def fast_convert_plain(x: torch.Tensor, conv: DeviceConverter) -> torch.Tensor:
    """The plain version of kernel C (troy_tpu ops/rns.py fast_convert)."""
    q_in, invp, invps, p_out, cr_lo, cr_hi, mat = conv.parts()
    col = lambda v: v.reshape(-1, 1)
    temp = u.mul_mod_shoup(x, col(invp), col(invps), col(q_in))
    lo = hi = None
    for i in range(conv.k_in):
        # (..., 1, n) * (k_out, 1) -> (..., k_out, n)
        plo, phi = u.mul128(temp[..., i:i + 1, :], col(mat[:, i]))
        lo, hi = (plo, phi) if lo is None else u.add_u128(lo, hi, plo, phi)
    return u.barrett_reduce_128(lo, hi, col(p_out), col(cr_lo), col(cr_hi))


def fast_convert(x: torch.Tensor, conv: DeviceConverter) -> torch.Tensor:
    """Approximate CRT base conversion (rns.cpp fastConvertArray):
    (..., k_in, n) -> (..., k_out, n). May overshoot by a multiple of the
    input base's product (the BEHZ alpha), as in the reference."""
    if x.dim() < 2 or x.shape[-2] != conv.k_in:
        raise ValueError(f"fast_convert: expected (..., {conv.k_in}, n), "
                         f"got {tuple(x.shape)}")
    if not _kernels.on_cuda(x, conv.consts):
        return fast_convert_plain(x, conv)
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"fast_convert: n = {n} is not a power of two")
    if max(conv.k_in, conv.k_out) > MAX_KERNEL_LIMBS:
        raise ValueError(f"fast_convert: {conv.k_in} -> {conv.k_out} limbs; "
                         f"the kernel takes at most {MAX_KERNEL_LIMBS}")
    x = x.contiguous()
    _kernels.check_operand(x, "fast_convert input")
    out = torch.empty(x.shape[:-2] + (conv.k_out, n), dtype=torch.int64,
                      device=x.device)
    _kernels.launch("troy_base_convert", out.get_device(), out, x,
                    x.numel() // (conv.k_in * n), conv.k_in, conv.k_out,
                    n.bit_length() - 1, conv.consts)
    return out


@dataclass(eq=False)
class DeviceRnsTool:
    """The RnsTool of one context level with its device constants.

    Kernel E's constants, one tensor per entry point, in the order
    csrc/behz.cu reads them (each ``shoup`` run is the reduced scalars, then
    their Shoup quotients):

    * ``lift_consts``: converter q -> Bsk u {m~}; shoup(m~ mod q_i);
      shoup(-Q^-1 mod m~); shoup(Q mod b_i); shoup(m~^-1 mod b_i);
    * ``tail_consts``: shoup(t mod q_i); shoup(t mod b_i); converter
      q -> Bsk; shoup(Q^-1 mod b_i); converter B -> q u {m_sk};
      shoup(B^-1 mod m_sk); shoup(B mod q_i); shoup(-B mod q_i);
    * ``decrypt_consts``: shoup(-Q^-1 mod t); shoup(-Q^-1 mod gamma); the
      high Barrett word of t; shoup(gamma^-1 mod t); t; gamma.

    ``q_to_t_gamma_scaled`` is kernel C's converter q -> {t, gamma} with
    the decrypt's premultiply by t gamma folded in.
    """

    host: RnsTool
    q: RnsNttTables                  # the level's base q
    bsk: RnsNttTables                # Bsk = B u {m_sk}
    q_bsk: RnsNttTables              # q then Bsk: the BFV product's base
    q_to_bsk: DeviceConverter
    q_to_bsk_m_tilde: DeviceConverter    # q -> Bsk u {m~}, one launch
    b_to_q_m_sk: DeviceConverter         # B -> q u {m_sk}, one launch
    q_to_t_gamma: DeviceConverter        # q -> {t, gamma}, decrypt
    q_to_t_gamma_scaled: DeviceConverter
    lift_consts: torch.Tensor
    tail_consts: torch.Tensor
    decrypt_consts: torch.Tensor

    @classmethod
    def build(cls, tool: RnsTool, q: RnsNttTables,
              bsk: RnsNttTables) -> "DeviceRnsTool":
        dev = q.device
        qv, bv = tool.base_q.values, tool.base_Bsk.values
        k, nb = len(qv), len(bv)
        t, gamma, m_tilde, m_sk = tool.t, tool.gamma, tool.m_tilde, tool.m_sk
        b_to_q_m_sk = BaseConverter(
            tool.base_B, RnsBase(tool.base_q.moduli + (
                tool.base_Bsk.moduli[-1],)))
        conv_q_bsk_mt = BaseConverter(tool.base_q, tool.base_Bsk_m_tilde)
        words = DeviceConverter.words
        lift = (words(conv_q_bsk_mt) + _shoup([m_tilde] * k, qv)
                + _shoup([tool.neg_inv_prod_q_mod_m_tilde], [m_tilde])
                + _shoup(tool.prod_q_mod_Bsk, bv)
                + _shoup(tool.inv_m_tilde_mod_Bsk, bv))
        prod_b = list(tool.prod_B_mod_q)
        tail = (_shoup([t] * k, qv) + _shoup([t] * nb, bv)
                + words(tool.conv_q_to_Bsk)
                + _shoup(tool.inv_prod_q_mod_Bsk, bv)
                + words(b_to_q_m_sk)
                + _shoup([tool.inv_prod_B_mod_m_sk], [m_sk])
                + _shoup(prod_b, qv)
                + _shoup([(qi - p) % qi for p, qi in zip(prod_b, qv)], qv))
        neg_inv = tool.neg_inv_q_mod_t_gamma
        decrypt = (_shoup([neg_inv[0]], [t]) + _shoup([neg_inv[1]], [gamma])
                   + [tool.base_t_gamma.moduli[0].const_ratio[1]]
                   + _shoup([tool.inv_gamma_mod_t], [t]) + [t, gamma])
        conv = lambda c: DeviceConverter.build(c, dev)
        return cls(
            host=tool, q=q, bsk=bsk, q_bsk=RnsNttTables.concat(q, bsk),
            q_to_bsk=conv(tool.conv_q_to_Bsk),
            q_to_bsk_m_tilde=conv(conv_q_bsk_mt),
            b_to_q_m_sk=conv(b_to_q_m_sk),
            q_to_t_gamma=conv(tool.conv_q_to_t_gamma),
            q_to_t_gamma_scaled=DeviceConverter.build(
                tool.conv_q_to_t_gamma, dev, tool.prod_t_gamma_mod_q),
            lift_consts=_words(lift, dev), tail_consts=_words(tail, dev),
            decrypt_consts=_words(decrypt, dev))

    @property
    def k(self) -> int:
        return self.host.base_q.size

    @property
    def nb(self) -> int:
        return self.host.base_Bsk.size


# --------------------------------------------------------------------------
# plain versions of kernel E (the CPU path; on the card, the comparison)
# --------------------------------------------------------------------------

def smul(x, s: int, q: int):
    """x * s mod q for one modulus and a host scalar s (Shoup); x may be
    any u64 word."""
    s %= q
    return u.mul_mod_shoup(x, s, u.shoup_quotient(s, q), q)


def _smul_rows(x: torch.Tensor, scalars, t: RnsNttTables) -> torch.Tensor:
    """x * s_i mod q_i per limb of (..., k, n), Shoup, fully reduced."""
    w, wq = t.scalar_operand(scalars)
    return rns_elementwise_plain(SCALAR_MUL, x, None, t, w, wq)


def fastbconv_m_tilde_plain(x: torch.Tensor,
                            tool: DeviceRnsTool) -> torch.Tensor:
    """q -> Bsk u {m~} with the m~ premultiplication for the Montgomery
    reduction (rns.cpp:1012-1037). (..., k, n) -> (..., |Bsk|+1, n)."""
    h = tool.host
    temp = _smul_rows(x, [h.m_tilde] * h.base_q.size, tool.q)
    return fast_convert_plain(temp, tool.q_to_bsk_m_tilde)


def sm_mrq_plain(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """Montgomery reduction mod m~: Bsk u {m~} -> Bsk (rns.cpp:943-983).
    (..., |Bsk|+1, n) -> (..., |Bsk|, n)."""
    h = tool.host
    nb = h.base_Bsk.size
    r = smul(x[..., nb:, :], h.neg_inv_prod_q_mod_m_tilde, h.m_tilde)
    # centered reduction of r mod m~ (a power of two) into each b_i
    b = tool.bsk.q.reshape(-1, 1)
    temp = torch.where(r >= h.m_tilde >> 1, r + (b - h.m_tilde), r)
    d = rns_elementwise_plain(ADD, _smul_rows(temp, h.prod_q_mod_Bsk,
                                              tool.bsk),
                              x[..., :nb, :], tool.bsk)
    return _smul_rows(d, h.inv_m_tilde_mod_Bsk, tool.bsk)


def fast_floor_plain(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """floor(x / Q): q u Bsk -> Bsk (rns.cpp:985-1010).
    (..., k + |Bsk|, n) -> (..., |Bsk|, n)."""
    h = tool.host
    k = h.base_q.size
    conv = fast_convert_plain(x[..., :k, :], tool.q_to_bsk)
    b = tool.bsk.q.reshape(-1, 1)
    diff = x[..., k:, :] + (b - conv)                 # < 2b, Shoup-safe
    return _smul_rows(diff, h.inv_prod_q_mod_Bsk, tool.bsk)


def fastbconv_sk_plain(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """Shenoy-Kumaresan conversion Bsk -> q (rns.cpp:879-941).
    (..., |Bsk|, n) -> (..., k, n)."""
    h = tool.host
    nb = h.base_B.size
    k = h.base_q.size
    m_sk = h.m_sk
    conv = fast_convert_plain(x[..., :nb, :], tool.b_to_q_m_sk)  # q u {m_sk}
    alpha = smul(conv[..., k:, :] + (m_sk - x[..., nb:, :]),
                 h.inv_prod_B_mod_m_sk, m_sk)             # (..., 1, n)
    prod_b = list(h.prod_B_mod_q)
    qv = h.base_q.values
    pb, pbs = tool.q.scalar_operand(prod_b)
    npb, npbs = tool.q.scalar_operand([qi - p for p, qi in zip(prod_b, qv)])
    col = lambda v: v.reshape(-1, 1)
    q = col(tool.q.q)
    neg_corr = u.mul_mod_shoup(m_sk - alpha, col(pb), col(pbs), q)
    pos_corr = u.mul_mod_shoup(alpha, col(npb), col(npbs), q)  # -alpha*B
    corr = torch.where(alpha > m_sk >> 1, neg_corr, pos_corr)
    return rns_elementwise_plain(ADD, conv[..., :k, :], corr, tool.q)


def behz_lift_plain(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """The plain version of kernel E's lift: (..., k, n) -> (..., |Bsk|, n)."""
    return sm_mrq_plain(fastbconv_m_tilde_plain(x, tool), tool)


def behz_tail_plain(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """The plain version of kernel E's tail: every limb times t, then
    floor by Q and Shenoy-Kumaresan: (..., k + |Bsk|, n) -> (..., k, n)."""
    scaled = _smul_rows(x, [tool.host.t] * (tool.k + tool.nb), tool.q_bsk)
    return fastbconv_sk_plain(fast_floor_plain(scaled, tool), tool)


def behz_decrypt_round_plain(tg: torch.Tensor,
                             tool: DeviceRnsTool) -> torch.Tensor:
    """The plain version of kernel E's decrypt rounding: the phase's
    residues mod {t, gamma}, (..., 2, n) -> round(t/Q * phase) mod t,
    (..., n) (rns.cpp:1039-1095)."""
    h = tool.host
    t, gamma = h.t, h.gamma
    vt = smul(tg[..., 0, :], h.neg_inv_q_mod_t_gamma[0], t)
    vg = smul(tg[..., 1, :], h.neg_inv_q_mod_t_gamma[1], gamma)
    cr_t_hi = h.base_t_gamma.moduli[0].const_ratio[1]
    neg_red = u.barrett_reduce_64(gamma - vg, t, cr_t_hi)
    pos_red = u.barrett_reduce_64(vg, t, cr_t_hi)
    corrected = torch.where(vg > gamma >> 1, u.add_mod(vt, neg_red, t),
                            u.sub_mod(vt, pos_red, t))
    return smul(corrected, h.inv_gamma_mod_t, t)


def decrypt_scale_and_round_plain(phase: torch.Tensor,
                                  tool: DeviceRnsTool) -> torch.Tensor:
    """BFV decrypt scaling: round(t/Q * phase) mod t by the gamma trick
    (rns.cpp:1039-1095). (..., k, n) -> (..., n) mod t."""
    temp = _smul_rows(phase, tool.host.prod_t_gamma_mod_q, tool.q)
    return behz_decrypt_round_plain(
        fast_convert_plain(temp, tool.q_to_t_gamma), tool)


# --------------------------------------------------------------------------
# kernel E wrappers
# --------------------------------------------------------------------------

def _behz_launch(entry: str, x: torch.Tensor, rows_in: int, rows_out,
                 tool: DeviceRnsTool, consts: torch.Tensor, *limbs):
    """Check x (..., rows_in, n), launch ``entry`` over its leading axes and
    return (..., rows_out, n) (or (..., n) when rows_out is None)."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"{entry}: n = {n} is not a power of two")
    if tool.k > MAX_KERNEL_LIMBS or tool.nb + 1 > MAX_KERNEL_LIMBS:
        raise ValueError(f"{entry}: {tool.k} limbs in q, {tool.nb} in Bsk; "
                         f"the kernel takes at most {MAX_KERNEL_LIMBS} per "
                         "base, m~ included")
    x = x.contiguous()
    _kernels.check_operand(x, f"{entry} input")
    lead = x.shape[:-2]
    shape = lead + ((n,) if rows_out is None else (rows_out, n))
    out = torch.empty(shape, dtype=torch.int64, device=x.device)
    _kernels.launch(entry, out.get_device(), out, x,
                    x.numel() // (rows_in * n), *limbs, n.bit_length() - 1,
                    consts, consts.numel())
    return out


def _check_limbs(x: torch.Tensor, rows: int, name: str) -> None:
    if x.dim() < 2 or x.shape[-2] != rows:
        raise ValueError(f"{name}: expected (..., {rows}, n), got "
                         f"{tuple(x.shape)}")


def behz_lift(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """The BEHZ lift q -> Bsk of the BFV multiply (fastbconv_m_tilde, then
    the Montgomery reduction sm_mrq) in one kernel-E launch:
    (..., k, n) -> (..., |Bsk|, n)."""
    _check_limbs(x, tool.k, "behz_lift")
    if not _kernels.on_cuda(x, tool.lift_consts):
        return behz_lift_plain(x, tool)
    return _behz_launch("troy_behz_lift", x, tool.k, tool.nb, tool,
                        tool.lift_consts, tool.k, tool.nb)


def behz_tail(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """The tail of the BFV multiply on the product's rows in q then Bsk
    (coefficient domain): times t, floor by Q (fast_floor), back to q
    (Shenoy-Kumaresan) in one kernel-E launch:
    (..., k + |Bsk|, n) -> (..., k, n)."""
    _check_limbs(x, tool.k + tool.nb, "behz_tail")
    if not _kernels.on_cuda(x, tool.tail_consts):
        return behz_tail_plain(x, tool)
    return _behz_launch("troy_behz_tail", x, tool.k + tool.nb, tool.k, tool,
                        tool.tail_consts, tool.k, tool.nb)


def behz_decrypt_round(tg: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """Kernel E's decrypt rounding: the phase's residues mod {t, gamma},
    (..., 2, n), to round(t/Q * phase) mod t, (..., n)."""
    _check_limbs(tg, 2, "behz_decrypt_round")
    if not _kernels.on_cuda(tg, tool.decrypt_consts):
        return behz_decrypt_round_plain(tg, tool)
    return _behz_launch("troy_behz_decrypt_round", tg, 2, None, tool,
                        tool.decrypt_consts)


def decrypt_scale_and_round(phase: torch.Tensor,
                            tool: DeviceRnsTool) -> torch.Tensor:
    """BFV decrypt scaling round(t/Q * phase) mod t: (..., k, n) ->
    (..., n). On the card, kernel C converts the phase times t gamma to
    {t, gamma} and kernel E rounds."""
    _check_limbs(phase, tool.k, "decrypt_scale_and_round")
    if not _kernels.on_cuda(phase, tool.decrypt_consts):
        return decrypt_scale_and_round_plain(phase, tool)
    return behz_decrypt_round(fast_convert(phase, tool.q_to_t_gamma_scaled),
                              tool)


# --------------------------------------------------------------------------
# kernel K': the divide by the last prime with rounding, NTT domain
# --------------------------------------------------------------------------
#
# x (s, k+1, n) holds NTT-form rows over q_0..q_{k-1} and, in row k, the
# prime p to divide by (the level's last prime for the CKKS rescale, the
# special prime for the key switch). Kernel A inverse-transforms row k,
# K' turns it into per-limb lazy temps, A forward-transforms those, and K'
# finishes (x - temp) * p^-1 with an optional accumulator
# (csrc/divide_round_ntt.cu). Constants: ops/keyswitch.divide_round_consts.
# On A's route the temps and the finish run inside A's forward passes
# (csrc/ntt.cu, ``ntt_forward_divide``): A inverse, then one fused forward.
#
# Each use names its entry points: (K''s temps, K''s finish, the fused
# forward), so each keeps its own launch counts.

RESCALE = ("troy_rescale_ntt_temps", "troy_rescale_ntt_finish",
           "troy_ntt_forward_rescale")
KEYSWITCH = ("troy_keyswitch_ntt_temps", "troy_keyswitch_ntt_finish",
             "troy_ntt_forward_keyswitch")
# K'-BGV: the t-corrected temps; the mod switch has its own finish entry,
# the key switch shares K''s
BGV_MOD_SWITCH = ("troy_bgv_mod_switch_ntt_temps",
                  "troy_bgv_mod_switch_ntt_finish",
                  "troy_ntt_forward_bgv_mod_switch")
BGV_KEYSWITCH = ("troy_bgv_keyswitch_ntt_temps", "troy_keyswitch_ntt_finish",
                 "troy_ntt_forward_bgv_keyswitch")
# the entries that take K'-BGV's temps (the key switch's finish is K''s)
_BGV_ENTRIES = {BGV_MOD_SWITCH[0], BGV_MOD_SWITCH[2], BGV_KEYSWITCH[0],
                BGV_KEYSWITCH[2]}


def _divide_consts(consts: torch.Tensor):
    k = (consts.numel() - 2) // 5
    cols = [consts[i * k:(i + 1) * k].reshape(-1, 1) for i in range(5)]
    p, half = (int(v) & u.M64 for v in consts[5 * k:].tolist())
    return k, cols, p, half


def divide_round_ntt_temps_plain(last: torch.Tensor,
                                 consts: torch.Tensor) -> torch.Tensor:
    """The plain version of K''s temps: last (s, n) coefficient form below
    p -> ((last + floor(p/2)) mod p) mod q_j + q_j - floor(p/2) mod q_j,
    (s, k, n), below 2 q_j (troy_tpu/ops/rns.py:224-234)."""
    _, (q, ratio, half_mod, _, _), p, half = _divide_consts(consts)
    lst = u.add_mod(last.unsqueeze(-2), half, p)
    return u.barrett_reduce_64(lst, q, ratio) + (q - half_mod)


def divide_round_ntt_finish_plain(x: torch.Tensor, temps: torch.Tensor,
                                  consts: torch.Tensor,
                                  acc: Optional[torch.Tensor] = None,
                                  group: Optional[int] = None
                                  ) -> torch.Tensor:
    """The plain version of K''s finish: (x_j + 4 q_j - temp_j) p^-1 mod
    q_j for rows j < k of x (s, k+1, n), temps (s, k, n) below 4 q_j, plus
    acc in the layout of ops/keyswitch.py (troy_tpu/ops/rns.py:238-243)."""
    k, (q, _, _, inv, inv_shoup), _, _ = _divide_consts(consts)
    out = u.mul_mod_shoup(x[:, :k] + (4 * q - temps), inv, inv_shoup, q)
    return dks.add_accumulator_plain(out, acc, q, group)


def _bgv_divide_consts(consts: torch.Tensor):
    """(k, (q, ratio, p mod q, its Shoup words) as (k, 1) columns,
    (tt, tt's high Barrett word, p^-1 mod tt, its Shoup word)) of
    ops/keyswitch.bgv_divide_consts."""
    k = (consts.numel() - 6) // 7
    col = lambda start: consts[start:start + k].reshape(-1, 1)
    scalars = tuple(int(v) & u.M64 for v in consts[5 * k + 2:5 * k + 6]
                    .tolist())
    return k, (col(0), col(k), col(5 * k + 6), col(6 * k + 6)), scalars


def bgv_divide_ntt_temps_plain(last: torch.Tensor,
                               consts: torch.Tensor) -> torch.Tensor:
    """The plain version of K'-BGV's temps: last (s, n) coefficient form
    below p -> neg_k = -(last mod tt) p^-1 mod tt, then
    (neg_k mod q_j) (p mod q_j) + (last mod q_j) mod q_j, (s, k, n), below
    q_j (troy_tpu/ops/rns.py:246-266 and evaluator.py:320-336)."""
    _, (q, ratio, pm, pm_shoup), (tt, tt_hi, inv, inv_shoup) = \
        _bgv_divide_consts(consts)
    neg_k = u.neg_mod(u.barrett_reduce_64(last, tt, tt_hi), tt)
    neg_k = u.mul_mod_shoup(neg_k, inv, inv_shoup, tt).unsqueeze(-2)
    delta = u.mul_mod_shoup(u.barrett_reduce_64(neg_k, q, ratio), pm,
                            pm_shoup, q)
    return u.add_mod(delta, u.barrett_reduce_64(last.unsqueeze(-2), q, ratio),
                     q)


def _ntt_temps(entry: str, last: torch.Tensor,
               consts: torch.Tensor) -> torch.Tensor:
    if last.dim() != 2:
        raise ValueError(f"{entry}: expected (s, n), got {tuple(last.shape)}")
    bgv = entry in _BGV_ENTRIES
    if not _kernels.on_cuda(last, consts):
        plain = (bgv_divide_ntt_temps_plain if bgv
                 else divide_round_ntt_temps_plain)
        return plain(last, consts)
    s, n = last.shape
    k = (consts.numel() - 6) // 7 if bgv else (consts.numel() - 2) // 5
    if k > KEYSWITCH_MAX_LIMBS or n & (n - 1):
        raise ValueError(f"{entry}: k = {k}, n = {n} not supported")
    last = last.contiguous()
    _kernels.check_operand(last, f"{entry} input")
    out = torch.empty((s, k, n), dtype=torch.int64, device=last.device)
    _kernels.launch(entry, out.get_device(), out, last, s, k,
                    n.bit_length() - 1, consts)
    return out


def _ntt_finish(entry: str, x: torch.Tensor, temps: torch.Tensor,
                consts: torch.Tensor, acc: Optional[torch.Tensor],
                group: Optional[int] = None) -> torch.Tensor:
    s, k, n = temps.shape
    if x.shape != (s, k + 1, n) or consts.numel() != 5 * k + 2:
        raise ValueError(f"{entry}: x {tuple(x.shape)}, temps "
                         f"{tuple(temps.shape)} and {consts.numel()} "
                         "constants do not fit")
    layout = dks.accumulator_layout(acc, s, k, n, group, entry)
    operands = [x, temps, consts] + ([acc] if acc is not None else [])
    if not _kernels.on_cuda(*operands):
        return divide_round_ntt_finish_plain(x, temps, consts, acc, group)
    x, temps = x.contiguous(), temps.contiguous()
    _kernels.check_operand(x, f"{entry} x")
    _kernels.check_operand(temps, f"{entry} temps")
    acc, a, group, groups = layout
    if acc is not None:
        _kernels.check_operand(acc, f"{entry} accumulator")
    out = torch.empty((s, k, n), dtype=torch.int64, device=x.device)
    _kernels.launch(entry, out.get_device(), out, x, temps, acc, s, a, group,
                    groups, k, n.bit_length() - 1, consts)
    return out


def ntt_forward_divide_plain(x: torch.Tensor, last: torch.Tensor,
                             tables: RnsNttTables, consts: torch.Tensor,
                             acc: Optional[torch.Tensor] = None,
                             group: Optional[int] = None,
                             bgv: bool = False) -> torch.Tensor:
    """The plain version of ``ntt_forward_divide``: K''s temps (K'-BGV's
    if ``bgv``), A's lazy forward, K''s finish."""
    temps = (bgv_divide_ntt_temps_plain if bgv
             else divide_round_ntt_temps_plain)(last, consts)
    return divide_round_ntt_finish_plain(
        x, dntt.ntt_forward_plain(temps, tables, lazy=True),
        consts[:5 * tables.k + 2], acc, group)


def ntt_forward_divide(entry: str, x: torch.Tensor, last: torch.Tensor,
                       tables: RnsNttTables, consts: torch.Tensor,
                       acc: Optional[torch.Tensor] = None,
                       group: Optional[int] = None) -> torch.Tensor:
    """The forward half of the divide on A's route (K''s temps in kernel
    A's first pass, its finish in A's last: one A call, csrc/ntt.cu): x
    (s, k+1, n) NTT form, last (s, n) the inverse transform of its row k
    (below p) -> (s, k, n), the words of K''s temps, A's lazy forward over
    ``tables`` (q_0..q_{k-1}) and K''s finish, plus acc in the layout of
    ops/keyswitch.py. ``entry``: one of the fused entries of RESCALE,
    KEYSWITCH, BGV_MOD_SWITCH, BGV_KEYSWITCH (the BGV ones take
    ops/keyswitch.bgv_divide_consts). Tables on J, a pointwise view, or
    more than KEYSWITCH_MAX_LIMBS limbs (the kernel's) raise, on either
    device."""
    bgv = entry in _BGV_ENTRIES
    k, n = tables.k, tables.n
    if tables.mxu is not None or tables.root_powers.shape[-1] != n:
        raise ValueError(f"{entry}: these tables hold no transform on A "
                         "(kernel J's, or a pointwise view)")
    if x.dim() != 3 or x.shape[1:] != (k + 1, n) or last.dim() != 2 \
            or last.shape != (x.shape[0], n) \
            or consts.numel() != (7 * k + 6 if bgv else 5 * k + 2):
        raise ValueError(f"{entry}: x {tuple(x.shape)}, last "
                         f"{tuple(last.shape)} and {consts.numel()} constants"
                         f" do not fit {k} limbs of n = {n}")
    if k > KEYSWITCH_MAX_LIMBS:
        raise ValueError(f"{entry}: k = {k} limbs; the kernel takes at most "
                         f"{KEYSWITCH_MAX_LIMBS}")
    s = x.shape[0]
    layout = dks.accumulator_layout(acc, s, k, n, group, entry)
    operands = [x, last, consts, tables.q] + ([acc] if acc is not None
                                              else [])
    if not _kernels.on_cuda(*operands):
        return ntt_forward_divide_plain(x, last, tables, consts, acc, group,
                                        bgv)
    x, last = x.contiguous(), last.contiguous()
    _kernels.check_operand(x, f"{entry} x")
    _kernels.check_operand(last, f"{entry} last row")
    acc, a, group, groups = layout
    if acc is not None:
        _kernels.check_operand(acc, f"{entry} accumulator")
    out = torch.empty((s, k, n), dtype=torch.int64, device=x.device)
    _kernels.launch(entry, out.get_device(), out, last, x, acc, s, a, group,
                    groups, k, tables.log_n, tables.root_powers,
                    tables.root_powers_shoup, tables.q, consts)
    return out


def divide_round_last_ntt(x: torch.Tensor, tables: RnsNttTables,
                          last_tables: RnsNttTables, consts: torch.Tensor,
                          acc: Optional[torch.Tensor] = None,
                          entries=KEYSWITCH,
                          group: Optional[int] = None,
                          forward: Callable = dntt.rns_ntt_forward,
                          inverse: Callable = dntt.rns_ntt_inverse
                          ) -> torch.Tensor:
    """x (s, k+1, n) NTT form -> (s, k, n) NTT form: rows 0..k-1 (over
    ``tables``) minus the rounded row k (over ``last_tables``, the prime p
    of ``consts``), times p^-1, plus acc in the layout of ops/keyswitch.py.
    ``entries`` names K''s entry points (and with them its launch counts);
    with the BGV entries, consts are ops/keyswitch.bgv_divide_consts, whose
    first 5k + 2 words the finish reads. ``forward`` and ``inverse`` are
    the transforms, called as A's (x, tables[, lazy]); a
    coefficient-sharded mesh passes kernel J's (parallel/sharding.py).
    On A's route (A's transforms over A's tables) kernels A inverse and the
    fused forward (``ntt_forward_divide``); otherwise A or J inverse, K''s
    temps, the forward, K''s finish."""
    k = x.shape[1] - 1
    last = inverse(x[:, k:], last_tables)[:, 0]
    if forward is dntt.rns_ntt_forward and inverse is dntt.rns_ntt_inverse \
            and tables.mxu is None:
        return ntt_forward_divide(entries[2], x, last, tables, consts, acc,
                                  group)
    temps = forward(_ntt_temps(entries[0], last, consts), tables, lazy=True)
    return _ntt_finish(entries[1], x, temps, consts[:5 * k + 2], acc, group)


def divide_and_round_q_last_ntt(x: torch.Tensor, t: RnsNttTables,
                                consts: torch.Tensor) -> torch.Tensor:
    """The CKKS rescale (rns.cpp:831-877): x (s, k, n) NTT form over the
    level's base t -> (s, k-1, n), divided by its last prime with rounding;
    consts = divide_round_consts(t.slice(0, k-1), that prime)."""
    if x.dim() != 3 or x.shape[1] != t.k or t.k < 2:
        raise ValueError(f"divide_and_round_q_last_ntt: expected (s, {t.k}, "
                         f"n) with at least two limbs, got {tuple(x.shape)}")
    return divide_round_last_ntt(x, t.slice(0, t.k - 1),
                                 t.slice(t.k - 1, t.k), consts, None,
                                 RESCALE)


def divide_and_round_q_last_ntt_plain(x: torch.Tensor, t: RnsNttTables,
                                      consts: torch.Tensor) -> torch.Tensor:
    """The rescale on the plain versions of A and K' alone."""
    k = t.k - 1
    last = dntt.ntt_inverse_plain(x[:, k:], t.slice(k, k + 1))[:, 0]
    return ntt_forward_divide_plain(x, last, t.slice(0, k), consts)


def mod_t_and_divide_q_last_ntt(x: torch.Tensor, t: RnsNttTables,
                                consts: torch.Tensor) -> torch.Tensor:
    """The BGV mod switch (rns.cpp modTAndDivideqLastNttInplace): x
    (s, k, n) NTT form over the level's base t -> (s, k-1, n), minus a
    multiple of the plain modulus that makes the last row divisible by the
    last prime, divided by it; consts = bgv_divide_consts(t.slice(0, k-1),
    that prime, tt). Kernel A's inverse and the fused forward on A's
    route (``divide_round_last_ntt``)."""
    if x.dim() != 3 or x.shape[1] != t.k or t.k < 2:
        raise ValueError(f"mod_t_and_divide_q_last_ntt: expected (s, {t.k}, "
                         f"n) with at least two limbs, got {tuple(x.shape)}")
    return divide_round_last_ntt(x, t.slice(0, t.k - 1),
                                 t.slice(t.k - 1, t.k), consts, None,
                                 BGV_MOD_SWITCH)


def mod_t_and_divide_q_last(x: torch.Tensor, t: RnsNttTables,
                            consts: torch.Tensor) -> torch.Tensor:
    """The BGV mod switch in the coefficient domain (rns.cpp:1097-1140;
    troy_tpu/ops/rns.py:281): x (s, k, n) over the level's base t ->
    (s, k-1, n), minus a multiple of the plain modulus that makes the last
    row divisible by the last prime, divided by it; consts =
    bgv_divide_consts(t.slice(0, k-1), that prime, tt). One kernel-K''
    launch."""
    if x.dim() != 3 or x.shape[1] != t.k or t.k < 2:
        raise ValueError(f"mod_t_and_divide_q_last: expected (s, {t.k}, n) "
                         f"with at least two limbs, got {tuple(x.shape)}")
    return dks.bgv_divide_last(x, consts)


def mod_t_and_divide_q_last_ntt_plain(x: torch.Tensor, t: RnsNttTables,
                                      consts: torch.Tensor) -> torch.Tensor:
    """The BGV mod switch on the plain versions of A and K'-BGV alone."""
    k = t.k - 1
    last = dntt.ntt_inverse_plain(x[:, k:], t.slice(k, k + 1))[:, 0]
    return ntt_forward_divide_plain(x, last, t.slice(0, k), consts, bgv=True)


# --------------------------------------------------------------------------
# kernel X: the exact conversion q -> t (BGV decrypt)
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class ExactConverter:
    """Kernel X's constants for a converter q -> {tt}, as
    csrc/exact_convert.cu reads them: q_i, (Q/q_i)^-1 mod q_i, its Shoup
    word, the low and the high word of floor(2^128 / q_i), (Q/q_i) mod tt
    (k each); then tt, the low and the high word of floor(2^128 / tt),
    Q mod tt and its Shoup word."""

    consts: torch.Tensor
    k: int
    t: int

    @classmethod
    def build(cls, conv: BaseConverter, device) -> "ExactConverter":
        ib, ob = conv.ibase, conv.obase
        if ob.size != 1:
            raise ValueError("exact_convert requires a single output modulus")
        tt = ob.values[0]
        q_mod = ib.base_prod % tt
        words = (list(ib.values) + list(conv.inv_punctured)
                 + list(conv.inv_punctured_shoup)
                 + [m.const_ratio[0] for m in ib.moduli]
                 + [m.const_ratio[1] for m in ib.moduli]
                 + list(conv.matrix[0])
                 + [tt, *ob.moduli[0].const_ratio[:2], q_mod,
                    u.shoup_quotient(q_mod, tt)])
        return cls(_words(words, device), ib.size, tt)


def exact_convert_plain(x: torch.Tensor, conv: ExactConverter,
                        inv_cf: int = 1) -> torch.Tensor:
    """The plain version of kernel X (troy_tpu/ops/rns.py:67-108, then the
    decrypt's multiply by the inverse correction factor,
    troy_tpu/decryptor.py:64-66): (..., k, n) -> (..., 1, n) mod tt.
    alpha = round(sum_i temp_i / q_i) in Q.64 fixed point, each term
    mulhi(temp_i, w_lo) + temp_i w_hi with w = floor(2^128 / q_i)."""
    k, consts = conv.k, conv.consts
    q, invp, invp_shoup, w_lo, w_hi, mat = (
        consts[i * k:(i + 1) * k] for i in range(6))
    tt, cr_lo, cr_hi, q_mod, q_mod_shoup = (
        int(v) & u.M64 for v in consts[6 * k:].tolist())
    temp = u.mul_mod_shoup(x, invp.reshape(-1, 1), invp_shoup.reshape(-1, 1),
                           q.reshape(-1, 1))
    zero = torch.zeros_like(temp[..., 0, :])
    frac_lo = frac_hi = acc_lo = acc_hi = zero
    for i in range(k):
        ti = temp[..., i, :]
        m_lo, m_hi = u.mul128(ti, w_hi[i])
        term = u.add_u128(u.mulhi64(ti, w_lo[i]), zero, m_lo, m_hi)
        frac_lo, frac_hi = u.add_u128(frac_lo, frac_hi, *term)
        acc_lo, acc_hi = u.add_u128(acc_lo, acc_hi, *u.mul128(ti, mat[i]))
    alpha = frac_hi + u.shr(frac_lo, 63)             # round half up
    total = u.barrett_reduce_128(acc_lo, acc_hi, tt, cr_lo, cr_hi)
    alpha_q = u.mul_mod_shoup(u.barrett_reduce_64(alpha, tt, cr_hi), q_mod,
                              q_mod_shoup, tt)
    out = u.sub_mod(total, alpha_q, tt)
    if inv_cf % tt != 1:
        out = smul(out, inv_cf, tt)
    return out.unsqueeze(-2)


def exact_convert(x: torch.Tensor, conv: ExactConverter,
                  inv_cf: int = 1) -> torch.Tensor:
    """Exact CRT conversion to one modulus tt (rns.cpp exactConvertArray,
    with the JAX package's Q.64 fixed-point alpha instead of doubles), the
    result times inv_cf mod tt, in one kernel-X launch: (..., k, n) ->
    (..., 1, n)."""
    k = conv.k
    _check_limbs(x, k, "exact_convert")
    if not _kernels.on_cuda(x, conv.consts):
        return exact_convert_plain(x, conv, inv_cf)
    n = x.shape[-1]
    if k > KEYSWITCH_MAX_LIMBS or n & (n - 1):
        raise ValueError(f"exact_convert: k = {k}, n = {n} not supported")
    inv_cf %= conv.t
    x = x.contiguous()
    _kernels.check_operand(x, "exact_convert input")
    out = torch.empty(x.shape[:-2] + (1, n), dtype=torch.int64,
                      device=x.device)
    _kernels.launch("troy_exact_convert", out.get_device(), out, x,
                    x.numel() // (k * n), k, n.bit_length() - 1, conv.consts,
                    inv_cf, u.shoup_quotient(inv_cf, conv.t))
    return out


def decrypt_mod_t(phase: torch.Tensor, conv: ExactConverter,
                  inv_cf: int = 1) -> torch.Tensor:
    """BGV decrypt: the coefficient-form phase (..., k, n) to its words
    mod t times the inverse correction factor, (..., n) (rns.cpp:1142-1146,
    kernel X)."""
    return exact_convert(phase, conv, inv_cf)[..., 0, :]


# --------------------------------------------------------------------------
# AXi and ACi: the decrypt's last step in kernel A's last inverse pass
# --------------------------------------------------------------------------
#
# On A's route the decrypt's conversion of the coefficient-form phase runs
# inside A's inverse (csrc/ntt.cu troy_ntt_inverse_decrypt_bgv, _bfv): a
# block of the last pass holds one column set of all k rows of a component
# and finishes whole coefficients with X's arithmetic, or C's and E's
# rounding (csrc/decrypt.cuh). Tables on J, or a level whose k rows one
# block cannot hold (the library's plan, ``decrypt_plan``), take A's or
# J's inverse and the standalone kernels instead: ``decrypt_fused`` says
# which, by shape.


def decrypt_plan(tables: RnsNttTables, bfv: bool) -> Optional[tuple]:
    """The plan of the fused pass (ACi for BFV, else AXi) at the level of
    ``tables`` on the card: ``ops/ntt.inverse_decrypt_plan`` for one
    component, asked once a level (whether a block holds the k rows does
    not depend on the components). None on the CPU, where the plain
    version takes any number of limbs."""
    if tables.q.device.type != "cuda":
        return None
    key = ("decrypt_plan", bfv)
    if key not in tables._memo:
        tables._memo[key] = dntt.inverse_decrypt_plan(1, tables.k, tables.n,
                                                      bfv)
    return tables._memo[key]


def decrypt_fused(tables: RnsNttTables, bfv: bool) -> bool:
    """Whether the decrypt over the level's ``tables`` runs fused into A's
    inverse (ACi for BFV, else AXi): A's tables and, on the card, a plan
    whose block holds all k rows."""
    if not dntt.on_a_route(tables):
        return False
    plan = decrypt_plan(tables, bfv)
    return plan is None or plan[2] == tables.k


def fold_inverse_degree(consts: torch.Tensor,
                        tables: RnsNttTables) -> torch.Tensor:
    """X's or C's constants (both hold q, the punctured inverses and their
    Shoup words at 0, k and 2k) with n^-1 mod q_j folded into the punctured
    inverses: a Shoup product by them turns a lazy word of A's inverse
    butterflies (below 2q, n^-1 not yet applied) straight into X's or C's
    temp, fully reduced, as n^-1, reduce_2q and the product by the
    punctured inverse give it. Made once per (constants, tables)."""
    key = ("inverse_degree_folded", id(consts))
    hit = tables._memo.get(key)
    if hit is None or hit[0] is not consts:
        k, n = tables.k, tables.n
        words = [int(v) & u.M64 for v in consts.tolist()]
        for j, q in enumerate(words[:k]):
            w = words[k + j] * pow(n, -1, q) % q
            words[k + j], words[2 * k + j] = w, u.shoup_quotient(w, q)
        hit = tables._memo[key] = (consts, _words(words, consts.device))
    return hit[1]


def ntt_inverse_decrypt_mod_t_plain(x: torch.Tensor, tables: RnsNttTables,
                                    conv: ExactConverter,
                                    inv_cf: int = 1) -> torch.Tensor:
    """The plain version of ``ntt_inverse_decrypt_mod_t``: A's inverse
    butterfly network, then X's."""
    return exact_convert_plain(dntt.ntt_inverse_plain(x, tables), conv,
                               inv_cf)[..., 0, :]


def ntt_inverse_decrypt_scale_and_round_plain(
        x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """The plain version of ``ntt_inverse_decrypt_scale_and_round``: A's
    inverse butterfly network, then C's and E's."""
    return decrypt_scale_and_round_plain(dntt.ntt_inverse_plain(x, tool.q),
                                         tool)


def _inverse_decrypt(entry: str, name: str, bfv: bool, x: torch.Tensor,
                     tables: RnsNttTables, conv_k: int, operands,
                     *consts) -> Optional[torch.Tensor]:
    """The fused decrypt's checks, then None on the CPU or the launch of
    ``entry`` with ``consts`` after the tables, the first (X's or C's) with
    n^-1 folded in."""
    if not dntt.on_a_route(tables):
        raise ValueError(f"{name}: these tables hold no transform on A "
                         "(kernel J's, or a pointwise view)")
    k, n = tables.k, tables.n
    if x.dim() < 2 or tuple(x.shape[-2:]) != (k, n) or conv_k != k:
        raise ValueError(f"{name}: x {tuple(x.shape)} and constants of "
                         f"{conv_k} limbs do not fit {k} limbs at n = {n}")
    plan = decrypt_plan(tables, bfv)
    if plan is not None and plan[2] != k:
        raise ValueError(f"{name}: one block of the fused pass cannot hold "
                         f"{k} limbs at n = {n}")
    if not _kernels.on_cuda(x, tables.q, *operands):
        return None
    x = x.contiguous()
    _kernels.check_operand(x, f"{name} input")
    # A's first pass writes its words here where the transform takes two
    # passes (lines shorter than the row)
    scratch = torch.empty_like(x) if plan[0] < tables.log_n else None
    out = torch.empty(x.shape[:-2] + (n,), dtype=torch.int64,
                      device=x.device)
    _kernels.launch(entry, out.get_device(), out, x, scratch,
                    x.numel() // (k * n), k, tables.log_n,
                    tables.inv_root_powers, tables.inv_root_powers_shoup,
                    tables.q, fold_inverse_degree(consts[0], tables),
                    *consts[1:])
    return out


def ntt_inverse_decrypt_mod_t(x: torch.Tensor, tables: RnsNttTables,
                              conv: ExactConverter,
                              inv_cf: int = 1) -> torch.Tensor:
    """The BGV decrypt's last step on A's route (AXi: kernel X folded into
    kernel A's last inverse pass, one call, csrc/ntt.cu
    ``troy_ntt_inverse_decrypt_bgv``): NTT-form phases x (..., k, n) over
    the level's ``tables`` -> (..., n), the words of
    ``rns_ntt_inverse(x, tables)`` then ``decrypt_mod_t(., conv,
    inv_cf)``. Tables on J, a pointwise view or a wrong shape raise on
    either device; more limbs than one block holds (``decrypt_plan``) on
    the card."""
    inv_cf %= conv.t
    out = _inverse_decrypt(
        "troy_ntt_inverse_decrypt_bgv", "ntt_inverse_decrypt_mod_t", False,
        x, tables, conv.k, (conv.consts,), conv.consts, inv_cf,
        u.shoup_quotient(inv_cf, conv.t))
    return ntt_inverse_decrypt_mod_t_plain(x, tables, conv, inv_cf) \
        if out is None else out


def ntt_inverse_decrypt_scale_and_round(x: torch.Tensor, tool: DeviceRnsTool
                                        ) -> torch.Tensor:
    """The BFV decrypt's last step on A's route (ACi: kernel C's
    conversion to {t, gamma} and kernel E's rounding folded into kernel
    A's last inverse pass, one call, csrc/ntt.cu
    ``troy_ntt_inverse_decrypt_bfv``): NTT-form phases x (..., k, n) over
    the level's tables ``tool.q`` -> (..., n), the words of
    ``rns_ntt_inverse(x, tool.q)`` then ``decrypt_scale_and_round(.,
    tool)``. The refusals as ``ntt_inverse_decrypt_mod_t``'s."""
    conv = tool.q_to_t_gamma_scaled
    out = _inverse_decrypt(
        "troy_ntt_inverse_decrypt_bfv", "ntt_inverse_decrypt_scale_and_round",
        True, x, tool.q, conv.k_in, (conv.consts, tool.decrypt_consts),
        conv.consts, tool.decrypt_consts)
    return ntt_inverse_decrypt_scale_and_round_plain(x, tool) \
        if out is None else out
