"""Evaluator: BFV add, sub, negate, multiply (BEHZ) and relinearize.

The port of troy_tpu/evaluator.py, BFV branches. The JAX package traces
each operation into one XLA program; here each step is a kernel launch
over the whole batch of polynomials and limbs it touches:

  * multiply lifts both operands to q and Bsk (kernel A over every
    component, kernels C and D for the lift), convolves in the NTT domain
    (kernel B), then scales by t, floors by Q and converts Bsk -> q
    (kernels A, C and D);
  * relinearize decomposes the target into RNS digits (one kernel-A launch
    over k x (k+1) limbs), takes the 128-bit inner product with the key
    (one kernel-B launch for both key components) and divides by the
    special prime (kernels A and D).

Glue (digit reductions, the rounding correction of the key switch) is plain
torch on the u64ops twin.
"""

from __future__ import annotations

from typing import List

import torch

from .context import ContextData, HeContext
from .he_types import Ciphertext, RelinKeys
from .params import SchemeType
from .ops import ntt as dntt
from .ops import poly as dpoly
from .ops import rns as drns
from .ops import u64ops as u
from .utils import numth

_LATER = ("is not ported yet (ROADMAP.md, queue 2: BGV, CKKS, square, "
          "mod switch, Galois and LWE come later)")


def _require_bfv(cd: ContextData) -> None:
    if cd.scheme != SchemeType.bfv:
        raise NotImplementedError(f"{cd.scheme.name} evaluation {_LATER}")


def _dyadic_convolution(a: torch.Tensor, b: torch.Tensor,
                        tables: dntt.RnsNttTables) -> torch.Tensor:
    """Ciphertext-degree convolution of NTT-domain components
    (kernelutils.cu:89-115): out[m] = sum_{i+j=m} a[i] * b[j], each output
    component one kernel-B launch with its terms summed in 128 bits.
    a: (s1, k, n), b: (s2, k, n), inputs lazy below 4q."""
    s1, s2 = a.shape[0], b.shape[0]
    outs = []
    for m in range(s1 + s2 - 1):
        lo, hi = max(0, m - s2 + 1), min(s1, m + 1)      # i in [lo, hi)
        # a[lo:hi] pairs with b[m-lo], ..., b[m-hi+1]: slices, so no index
        # list goes to the device
        outs.append(dntt.dyadic_mac(a[lo:hi], b[m - hi + 1:m - lo + 1]
                                    .flip(0), tables))
    return torch.stack(outs)


def _bfv_multiply(d1: torch.Tensor, d2: torch.Tensor,
                  cd: ContextData) -> torch.Tensor:
    """BEHZ RNS multiplication (evaluator_cuda.cu:283-382): lift to q and
    Bsk, dyadic-convolve in both bases, scale by t, fast-floor by Q,
    convert Bsk -> q."""
    tool = cd.rns
    qt, bt = cd.ntt, cd.bsk_ntt
    s1 = d1.shape[0]
    both = torch.cat([d1, d2])                          # every component
    q_ntt = dntt.rns_ntt_forward(both, qt, lazy=True)
    bsk = drns.sm_mrq(drns.fastbconv_m_tilde(both, tool), tool)
    bsk_ntt = dntt.rns_ntt_forward(bsk, bt, lazy=True)

    prod_q = _dyadic_convolution(q_ntt[:s1], q_ntt[s1:], qt)
    prod_b = _dyadic_convolution(bsk_ntt[:s1], bsk_ntt[s1:], bt)

    t_plain = int(cd.plain_modulus)
    cq = dpoly.rns_broadcast_scalar_mul(dntt.rns_ntt_inverse(prod_q, qt),
                                        t_plain, qt)
    cb = dpoly.rns_broadcast_scalar_mul(dntt.rns_ntt_inverse(prod_b, bt),
                                        t_plain, bt)
    floored = drns.fast_floor(torch.cat([cq, cb], dim=-2), tool)   # -> Bsk
    return drns.fastbconv_sk(floored, tool)                        # -> q


def _used_limbs(cd: ContextData, key_cd: ContextData) -> List[int]:
    """The key switch's working base: the data limbs and the special
    prime (evaluator.py:193)."""
    return list(range(cd.limbs)) + [key_cd.limbs - 1]


def _switch_key_decompose(target: torch.Tensor, cd: ContextData,
                          key_cd: ContextData) -> torch.Tensor:
    """RNS-digit decomposition of the coefficient-form target (k, n),
    reduced mod every used key prime and NTT'd: t_hat (k, used, n), fully
    reduced, in one kernel-A launch. Barrett-64 leaves a word already below
    the prime unchanged, so every digit is reduced without a branch on the
    primes' sizes."""
    used_tables = key_cd.ntt.select(_used_limbs(cd, key_cd))
    p = used_tables.q.reshape(-1, 1)                          # (used, 1)
    t_mat = u.barrett_reduce_64(target.unsqueeze(-2), p,
                                used_tables.cr_hi.reshape(-1, 1))
    return dntt.rns_ntt_forward(t_mat, used_tables)


def _switch_key_inner_product(t_hat: torch.Tensor, key: torch.Tensor,
                              cd: ContextData,
                              key_cd: ContextData) -> torch.Tensor:
    """The 128-bit inner product over the decomposition axis, both key
    components in one kernel-B launch: (2, used, n), fully reduced."""
    k = cd.limbs
    key_used = torch.cat([key[:k, :, :k], key[:k, :, -1:]], dim=2)
    used_tables = key_cd.ntt.select(_used_limbs(cd, key_cd))
    return dntt.dyadic_mac(t_hat, key_used, used_tables)


def _switch_key_contract(t_hat: torch.Tensor, key: torch.Tensor,
                         cd: ContextData,
                         key_cd: ContextData) -> torch.Tensor:
    """The inner product against the switching key, then the divide by
    the special prime with rounding, for both components: (2, k, n) in
    the coefficient domain (BFV)."""
    k = cd.limbs
    key_values = key_cd.coeff_values
    kf = len(key_values)
    p_sp = key_values[-1]
    prods = _switch_key_inner_product(t_hat, key, cd, key_cd)  # (2, used, n)

    last = dntt.ntt_inverse_limb(prods[:, -1], key_cd.ntt, kf - 1)
    half = p_sp >> 1
    last = u.add_mod(last, half, p_sp)                        # (2, n)
    qk = cd.ntt.q.reshape(k, 1)
    tmp = u.barrett_reduce_64(last.unsqueeze(-2), qk,
                              cd.ntt.cr_hi.reshape(k, 1))     # (2, k, n)
    half_mod = cd.ntt.scalar_operand([half] * k)[0].reshape(k, 1)
    temp = u.sub_mod(tmp, half_mod, qk)
    body = dntt.rns_ntt_inverse(prods[:, :-1], cd.ntt)
    diff = dpoly.rns_sub(body, temp, cd.ntt)
    inv_p = [numth.invert_mod(p_sp % qv, qv) for qv in cd.coeff_values]
    return dpoly.rns_scalar_mul(diff, inv_p, cd.ntt)


def _switch_key_core(target: torch.Tensor, key: torch.Tensor,
                     cd: ContextData, key_cd: ContextData,
                     target_ntt_form: bool) -> torch.Tensor:
    """The key switch (evaluator_cuda.cu:1163-1362): target (k, n) in the
    ciphertext's domain, key (decomp, 2, key_limbs, n) NTT form. Returns
    (2, k, n) to add onto (c0, c1)."""
    if target_ntt_form:
        raise NotImplementedError(f"key switching of NTT-form targets "
                                  f"{_LATER}")
    t_hat = _switch_key_decompose(target, cd, key_cd)
    return _switch_key_contract(t_hat, key, cd, key_cd)


def _relinearize_core(data: torch.Tensor, keys, cd: ContextData,
                      key_cd: ContextData,
                      target_ntt_form: bool) -> torch.Tensor:
    """Relinearization (size s -> 2): every c_p (p >= 2) key-switched and
    folded into (c0, c1) (evaluator_cuda.cu:703)."""
    c01 = data[:2]
    for i, key in enumerate(keys):
        delta = _switch_key_core(data[2 + i], key, cd, key_cd,
                                 target_ntt_form)
        c01 = dpoly.rns_add(c01, delta, cd.ntt)
    return c01


class Evaluator:
    """(evaluator.h:72), BFV."""

    def __init__(self, context: HeContext):
        self.context = context

    def _cd(self, ct: Ciphertext) -> ContextData:
        cd = self.context.get_context_data(ct.level)
        _require_bfv(cd)
        return cd

    @staticmethod
    def _check_same(a: Ciphertext, b: Ciphertext) -> None:
        if a.level != b.level:
            raise ValueError("ciphertexts are at different chain levels")
        if a.is_ntt_form != b.is_ntt_form:
            raise ValueError("NTT form mismatch")

    def negate(self, ct: Ciphertext) -> Ciphertext:
        return ct.replace(data=dpoly.rns_neg(ct.data, self._cd(ct).ntt))

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._add_sub(a, b, subtract=False)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._add_sub(a, b, subtract=True)

    def _add_sub(self, a: Ciphertext, b: Ciphertext,
                 subtract: bool) -> Ciphertext:
        self._check_same(a, b)
        t = self._cd(a).ntt
        s = min(a.size, b.size)
        op = dpoly.rns_sub if subtract else dpoly.rns_add
        parts = [op(a.data[:s], b.data[:s], t)]
        if a.size > s:
            parts.append(a.data[s:])
        elif b.size > s:
            parts.append(dpoly.rns_neg(b.data[s:], t) if subtract
                         else b.data[s:])
        return a.replace(data=torch.cat(parts))

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_same(a, b)
        cd = self._cd(a)
        if a.is_ntt_form:
            raise ValueError("BFV multiply expects coefficient form")
        return a.replace(data=_bfv_multiply(a.data, b.data, cd))

    def relinearize(self, ct: Ciphertext,
                    relin_keys: RelinKeys) -> Ciphertext:
        """Reduce the ciphertext size back to 2 (evaluator_cuda.cu:703)."""
        if ct.size == 2:
            return ct
        cd = self._cd(ct)
        keys = tuple(relin_keys.keys[p] for p in range(2, ct.size))
        data = _relinearize_core(ct.data, keys, cd,
                                 self.context.key_context_data,
                                 ct.is_ntt_form)
        return ct.replace(data=data)
