"""RNS base conversion and the BEHZ tool operations (BFV subset).

The port of troy_tpu/ops/rns.py: ``fast_convert`` and the BFV multiply's
lift and tail (``fastbconv_m_tilde``, ``sm_mrq``, ``fast_floor``,
``fastbconv_sk``) and the BFV decrypt rounding (``decrypt_scale_and_round``).
An RNS polynomial is a (..., k, n) int64 tensor of u64 words; every
function here also takes leading batch axes, so the components of a
ciphertext go through in one call.

``fast_convert`` is kernel C (csrc/base_convert.cu) for tensors on CUDA and
its plain version for tensors on the CPU. The other functions run their
heavy parts on kernels C and D (the per-limb Shoup products of
ops/poly.rns_scalar_mul) and their per-limb corrections in plain torch on
the u64ops twin.

The host RnsTool (utils/rns.py) holds every constant as Python ints;
``DeviceRnsTool`` packs what these functions need into small tensors on the
context's device once per context level.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import u64ops as u
from .. import _kernels
from ..interop import to_torch
from ..utils.rns import BaseConverter, RnsBase, RnsTool
from .ntt import RnsNttTables
from .poly import rns_add, rns_scalar_mul

# Kernel C keeps a converter's constants in a fixed shared-memory block.
MAX_KERNEL_LIMBS = 16


@dataclass(frozen=True, eq=False)
class DeviceConverter:
    """One base converter's constants, packed as kernel C reads them:
    [q_in, inv_punctured, inv_punctured_shoup (k_in each),
     p_out, cr_lo, cr_hi (k_out each), M (k_out x k_in)]."""

    consts: torch.Tensor
    k_in: int
    k_out: int

    @classmethod
    def build(cls, conv: BaseConverter, device) -> "DeviceConverter":
        ib, ob = conv.ibase, conv.obase
        words = (list(ib.values) + list(conv.inv_punctured)
                 + list(conv.inv_punctured_shoup) + list(ob.values)
                 + [m.const_ratio[0] for m in ob.moduli]
                 + [m.const_ratio[1] for m in ob.moduli]
                 + [x for row in conv.matrix for x in row])
        return cls(to_torch(np.array(words, dtype=np.uint64), device),
                   ib.size, ob.size)

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
    _kernels.launch("troy_base_convert", out, x, x.numel() // (conv.k_in * n),
                    conv.k_in, conv.k_out, n.bit_length() - 1, conv.consts)
    return out


@dataclass(eq=False)
class DeviceRnsTool:
    """The RnsTool of one context level with its device constants."""

    host: RnsTool
    q: RnsNttTables                  # the level's base q
    bsk: RnsNttTables                # Bsk = B u {m_sk}
    q_to_bsk: DeviceConverter
    q_to_bsk_m_tilde: DeviceConverter    # q -> Bsk u {m~}, one launch
    b_to_q_m_sk: DeviceConverter         # B -> q u {m_sk}, one launch
    q_to_t_gamma: DeviceConverter        # q -> {t, gamma}, decrypt
    sk_cols: torch.Tensor            # (4, k, 1): prod_B mod q_i and
    #                                  (q_i - it), each with its Shoup word

    @classmethod
    def build(cls, tool: RnsTool, q: RnsNttTables,
              bsk: RnsNttTables) -> "DeviceRnsTool":
        dev = q.device
        qv = tool.base_q.values
        pb = list(tool.prod_B_mod_q)
        npb = [(qi - p) % qi for p, qi in zip(pb, qv)]
        rows = [pb, [u.shoup_quotient(p, qi) for p, qi in zip(pb, qv)],
                npb, [u.shoup_quotient(p, qi) for p, qi in zip(npb, qv)]]
        b_to_q_m_sk = BaseConverter(
            tool.base_B, RnsBase(tool.base_q.moduli + (
                tool.base_Bsk.moduli[-1],)))
        conv = lambda c: DeviceConverter.build(c, dev)
        return cls(
            host=tool, q=q, bsk=bsk,
            q_to_bsk=conv(tool.conv_q_to_Bsk),
            q_to_bsk_m_tilde=conv(BaseConverter(tool.base_q,
                                                tool.base_Bsk_m_tilde)),
            b_to_q_m_sk=conv(b_to_q_m_sk),
            q_to_t_gamma=conv(tool.conv_q_to_t_gamma),
            sk_cols=to_torch(np.array(rows, dtype=np.uint64)[..., None], dev))


def smul(x, s: int, q: int):
    """x * s mod q for one modulus and a host scalar s (Shoup); x may be
    any u64 word."""
    s %= q
    return u.mul_mod_shoup(x, s, u.shoup_quotient(s, q), q)


def fastbconv_m_tilde(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """q -> Bsk u {m~} with the m~ premultiplication for the Montgomery
    reduction (rns.cpp:1012-1037). (..., k, n) -> (..., |Bsk|+1, n)."""
    h = tool.host
    temp = rns_scalar_mul(x, [h.m_tilde] * h.base_q.size, tool.q)
    return fast_convert(temp, tool.q_to_bsk_m_tilde)


def sm_mrq(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """Montgomery reduction mod m~: Bsk u {m~} -> Bsk (rns.cpp:943-983).
    (..., |Bsk|+1, n) -> (..., |Bsk|, n)."""
    h = tool.host
    nb = h.base_Bsk.size
    r = smul(x[..., nb:, :], h.neg_inv_prod_q_mod_m_tilde, h.m_tilde)
    # centered reduction of r mod m~ (a power of two) into each b_i
    b = tool.bsk.q.reshape(-1, 1)
    temp = torch.where(r >= h.m_tilde >> 1, r + (b - h.m_tilde), r)
    d = rns_add(rns_scalar_mul(temp, h.prod_q_mod_Bsk, tool.bsk),
                x[..., :nb, :].contiguous(), tool.bsk)
    return rns_scalar_mul(d, h.inv_m_tilde_mod_Bsk, tool.bsk)


def fast_floor(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """floor(x / Q): q u Bsk -> Bsk (rns.cpp:985-1010).
    (..., k + |Bsk|, n) -> (..., |Bsk|, n)."""
    h = tool.host
    k = h.base_q.size
    conv = fast_convert(x[..., :k, :], tool.q_to_bsk)
    b = tool.bsk.q.reshape(-1, 1)
    diff = x[..., k:, :] + (b - conv)                 # < 2b, Shoup-safe
    return rns_scalar_mul(diff, h.inv_prod_q_mod_Bsk, tool.bsk)


def fastbconv_sk(x: torch.Tensor, tool: DeviceRnsTool) -> torch.Tensor:
    """Shenoy-Kumaresan conversion Bsk -> q (rns.cpp:879-941).
    (..., |Bsk|, n) -> (..., k, n)."""
    h = tool.host
    nb = h.base_B.size
    k = h.base_q.size
    m_sk = h.m_sk
    conv = fast_convert(x[..., :nb, :], tool.b_to_q_m_sk)  # q u {m_sk}
    alpha = smul(conv[..., k:, :] + (m_sk - x[..., nb:, :]),
                 h.inv_prod_B_mod_m_sk, m_sk)             # (..., 1, n)
    pb, pbs, npb, npbs = tool.sk_cols
    q = tool.q.q.reshape(-1, 1)
    neg_corr = u.mul_mod_shoup(m_sk - alpha, pb, pbs, q)  # alpha was negative
    pos_corr = u.mul_mod_shoup(alpha, npb, npbs, q)       # -alpha * prod(B)
    corr = torch.where(alpha > m_sk >> 1, neg_corr, pos_corr)
    return rns_add(conv[..., :k, :].contiguous(), corr, tool.q)


def decrypt_scale_and_round(phase: torch.Tensor,
                            tool: DeviceRnsTool) -> torch.Tensor:
    """BFV decrypt scaling: round(t/Q * phase) mod t by the gamma trick
    (rns.cpp:1039-1095). (..., k, n) -> (..., n) mod t."""
    h = tool.host
    t, gamma = h.t, h.gamma
    temp = rns_scalar_mul(phase, h.prod_t_gamma_mod_q, tool.q)
    tg = fast_convert(temp, tool.q_to_t_gamma)
    vt = smul(tg[..., 0, :], h.neg_inv_q_mod_t_gamma[0], t)
    vg = smul(tg[..., 1, :], h.neg_inv_q_mod_t_gamma[1], gamma)
    cr_t_hi = h.base_t_gamma.moduli[0].const_ratio[1]
    neg_red = u.barrett_reduce_64(gamma - vg, t, cr_t_hi)
    pos_red = u.barrett_reduce_64(vg, t, cr_t_hi)
    corrected = torch.where(vg > gamma >> 1, u.add_mod(vt, neg_red, t),
                            u.sub_mod(vt, pos_red, t))
    return smul(corrected, h.inv_gamma_mod_t, t)
