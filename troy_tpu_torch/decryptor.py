"""Decryptor: the phase <ct, (1, s, s^2, ...)>, BFV scale-and-round, BGV
reduction mod t, and the invariant noise budget.

The port of troy_tpu/decryptor.py. The phase accumulates in the NTT domain
against cached secret-key powers: every component's forward NTT is one
kernel-A launch (none for an NTT-form CKKS or BGV ciphertext), and c0 plus
the sum of products one kernel-B launch, which reads the level's rows of
the cached powers in place. CKKS returns that NTT-form phase as the
plaintext; BFV takes the inverse NTT and the t/Q rounding (kernels C and
E), BGV the inverse NTT and the exact conversion to t with the inverse
correction factor fused in (kernel X):
on A's route one call, the conversion inside A's last inverse pass (ACi
``ntt_inverse_decrypt_scale_and_round``, AXi ``ntt_inverse_decrypt_mod_t``),
elsewhere (tables on J, or more limbs than one block of that pass holds)
A's or J's inverse, then ``decrypt_scale_and_round`` or ``decrypt_mod_t``.
``decrypt_many`` does each of those steps once for a whole batch of
ciphertexts, so its launch count does not grow with the batch, and copies
the results to the host once. The noise budget (BFV, BGV) reads the phase
back and measures it with host integers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .context import ContextData, HeContext
from .he_types import Ciphertext, Plaintext, SecretKey
from .interop import to_numpy
from .params import SchemeType
from .utils import numth
from .ops import ntt as dntt
from .ops import rns as drns


def _phase_ntt_core(data: torch.Tensor, sk_powers: torch.Tensor,
                    cd: ContextData, is_ntt_form: bool) -> torch.Tensor:
    """c0 + c1 s + c2 s^2 + ... in the NTT domain, (k, n)
    (decryptor_cuda.cu:262-329 dotProductCtSkArray). sk_powers:
    (size - 1, key_limbs, n), s^1 first."""
    t = cd.ntt
    comps = data if is_ntt_form else dntt.rns_ntt_forward(data, t)
    return dntt.dyadic_mac(comps[1:], sk_powers[:, :cd.limbs], t,
                           addend=comps[0])


def _phase_ntt_many(data: torch.Tensor, sk_powers: torch.Tensor,
                    cd: ContextData, is_ntt_form: bool) -> torch.Tensor:
    """The NTT-form phases of a batch (B, size, k, n) -> (B, k, n)
    (troy_tpu/decryptor.py:71): one A launch over every component (none in
    NTT form) and one B launch for c0 + c1 s + c2 s^2 + ... of every
    ciphertext (the powers' level rows read in place)."""
    t = cd.ntt
    comps = data if is_ntt_form else dntt.rns_ntt_forward(data, t)
    powers = sk_powers[:, :cd.limbs].unsqueeze(1)       # (size - 1, 1, k, n)
    return dntt.dyadic_mac_batched(powers, comps[:, 1:], t,
                                   addend=comps[:, :1])[:, 0]


def _phase_core(data: torch.Tensor, sk_powers: torch.Tensor,
                cd: ContextData, is_ntt_form: bool) -> torch.Tensor:
    """The phase in the coefficient domain, (k, n)."""
    return dntt.rns_ntt_inverse(
        _phase_ntt_core(data, sk_powers, cd, is_ntt_form), cd.ntt)


def _decrypt_phase(phase: torch.Tensor, cd: ContextData,
                   inv_cf: int = 1) -> torch.Tensor:
    """NTT-form phases (..., k, n) to plaintext words mod t, (..., n):
    BFV's t/Q rounding, BGV's reduction mod t times the inverse correction
    factor inv_cf. One fused call where ``drns.decrypt_fused`` says so (A's
    route), else the inverse transform and the standalone conversion."""
    bfv = cd.scheme != SchemeType.bgv
    if drns.decrypt_fused(cd.ntt, bfv):
        if bfv:
            return drns.ntt_inverse_decrypt_scale_and_round(phase, cd.rns)
        return drns.ntt_inverse_decrypt_mod_t(phase, cd.ntt, cd.exact_to_t,
                                              inv_cf)
    coeff = dntt.rns_ntt_inverse(phase, cd.ntt)
    if bfv:
        return drns.decrypt_scale_and_round(coeff, cd.rns)
    return drns.decrypt_mod_t(coeff, cd.exact_to_t, inv_cf)


def _decrypt_core(data: torch.Tensor, sk_powers: torch.Tensor,
                  cd: ContextData, is_ntt_form: bool,
                  inv_cf: int = 1) -> torch.Tensor:
    """BFV or BGV decrypt to plaintext words mod t, (n,); BGV's times the
    inverse correction factor inv_cf."""
    return _decrypt_phase(_phase_ntt_core(data, sk_powers, cd, is_ntt_form),
                          cd, inv_cf)


class Decryptor:
    """(decryptor.h:47)"""

    def __init__(self, context: HeContext, secret_key: SecretKey):
        self.context = context
        self._sk = secret_key
        # NTT-form powers of s over the key base, s^1 first
        self._sk_powers: Dict[int, torch.Tensor] = {1: secret_key.data}
        # s^1 .. s^(size - 1) stacked, for each ciphertext size decrypted
        self._stacked: Dict[int, torch.Tensor] = {}

    def _sk_power(self, p: int) -> torch.Tensor:
        if p not in self._sk_powers:
            cd = self.context.key_context_data
            self._sk_powers[p] = dntt.rns_dyadic_mul(
                self._sk_power(p - 1), self._sk.data, cd.ntt)
        return self._sk_powers[p]

    def _powers(self, ct: Ciphertext) -> torch.Tensor:
        """(size - 1, key_limbs, n), made once for each size: kernel B
        reads a level's rows of it in place, so a decrypt copies nothing."""
        if ct.size not in self._stacked:
            self._stacked[ct.size] = torch.stack(
                [self._sk_power(p) for p in range(1, ct.size)])
        return self._stacked[ct.size]

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        cd = self.context.get_context_data(ct.level)
        powers = self._powers(ct)
        if self.context.scheme == SchemeType.ckks:
            # the NTT-form phase, at the ciphertext's level and scale
            return Plaintext(data=_phase_ntt_core(ct.data, powers, cd,
                                                  ct.is_ntt_form),
                             level=ct.level, is_ntt_form=True,
                             scale=ct.scale)
        inv_cf = 1
        if self.context.scheme == SchemeType.bgv and ct.correction_factor != 1:
            t = int(cd.plain_modulus)
            inv_cf = numth.invert_mod(ct.correction_factor % t, t)
        return Plaintext(data=_decrypt_core(ct.data, powers, cd,
                                            ct.is_ntt_form, inv_cf))

    def decrypt_many(self, cts: Sequence[Ciphertext]) -> List[Plaintext]:
        """Batched decryption (troy_tpu/decryptor.py:124): the ciphertexts,
        which must share size, level, NTT form and (BGV) correction factor,
        go through each step of ``decrypt`` together, one launch per step
        whatever their number (``_phase_ntt_many``, then ``_decrypt_phase``:
        ACi or AXi on A's route), and come to the host
        in one copy: the plaintexts hold CPU tensors. CKKS returns each
        NTT-form phase with its ciphertext's level and scale. One
        ciphertext goes to ``decrypt``."""
        cts = list(cts)
        if not cts:
            return []
        if len(cts) == 1:
            return [self.decrypt(cts[0])]
        first = cts[0]
        for c in cts[1:]:
            if (c.size != first.size or c.level != first.level
                    or c.is_ntt_form != first.is_ntt_form
                    or c.correction_factor != first.correction_factor):
                raise ValueError("decrypt_many needs uniform ciphertexts")
        cd = self.context.get_context_data(first.level)
        scheme = self.context.scheme
        stacked = torch.stack([c.data for c in cts])
        phase = _phase_ntt_many(stacked, self._powers(first), cd,
                                first.is_ntt_form)
        if scheme == SchemeType.ckks:
            host = phase.cpu()
            return [Plaintext(data=host[i], level=first.level,
                              is_ntt_form=True, scale=c.scale)
                    for i, c in enumerate(cts)]
        inv_cf = 1
        if scheme == SchemeType.bgv and first.correction_factor != 1:
            t = int(cd.plain_modulus)
            inv_cf = numth.invert_mod(first.correction_factor % t, t)
        host = _decrypt_phase(phase, cd, inv_cf).cpu()
        return [Plaintext(data=host[i]) for i in range(len(cts))]

    def invariant_noise_budget(self, ct: Ciphertext) -> int:
        """Bits of noise budget left: log2(Q/2) - log2(2 ||t/Q phase - m||)
        (decryptor.cpp invariantNoiseBudget). The phase comes from the
        device (kernels A, B); the norm is taken in host integers, as a
        diagnostic off the hot path. BFV and BGV."""
        if self.context.scheme == SchemeType.ckks:
            raise ValueError("the invariant noise budget is BFV/BGV-only")
        cd = self.context.get_context_data(ct.level)
        phase = to_numpy(_phase_core(ct.data, self._powers(ct), cd,
                                     ct.is_ntt_form))
        base = cd.rns_tool.base_q
        Q = base.base_prod
        # compose each coefficient, times t, centered mod Q
        acc = np.zeros(cd.n, dtype=object)
        for i, qi in enumerate(base.values):
            acc += (phase[i].astype(object) * base.inv_punctured(i) % qi
                    * base.punctured_prod(i))
        v = acc * int(cd.plain_modulus) % Q
        norm = int(np.minimum(v, Q - v).max())
        # bits(Q) - bits(norm) - 1; the -1 scales the invariant noise by 2
        # (decryptor.cpp:439-441)
        return max(Q.bit_length() - norm.bit_length() - 1, 0)
