"""Decryptor: the phase <ct, (1, s, s^2, ...)> and BFV scale-and-round.

The port of troy_tpu/decryptor.py (BFV). The phase accumulates in the NTT
domain against cached secret-key powers: every component's forward NTT is
one kernel-A launch, the sum of products one kernel-B launch, then the
inverse NTT and the t/Q rounding (decrypt_scale_and_round).
"""

from __future__ import annotations

from typing import Dict

import torch

from .context import ContextData, HeContext
from .he_types import Ciphertext, Plaintext, SecretKey
from .params import SchemeType
from .ops import ntt as dntt
from .ops import poly as dpoly
from .ops import rns as drns


def _phase_ntt_core(data: torch.Tensor, sk_powers: torch.Tensor,
                    cd: ContextData, is_ntt_form: bool) -> torch.Tensor:
    """c0 + c1 s + c2 s^2 + ... in the NTT domain, (k, n)
    (decryptor_cuda.cu:262-329 dotProductCtSkArray). sk_powers:
    (size - 1, key_limbs, n), s^1 first."""
    t = cd.ntt
    comps = data if is_ntt_form else dntt.rns_ntt_forward(data, t)
    powers = sk_powers[:, :cd.limbs].contiguous()
    return dpoly.rns_add(comps[0], dntt.dyadic_mac(comps[1:], powers, t), t)


def _decrypt_core(data: torch.Tensor, sk_powers: torch.Tensor,
                  cd: ContextData, is_ntt_form: bool) -> torch.Tensor:
    """BFV decrypt to plaintext words mod t, (n,)."""
    phase = dntt.rns_ntt_inverse(
        _phase_ntt_core(data, sk_powers, cd, is_ntt_form), cd.ntt)
    return drns.decrypt_scale_and_round(phase, cd.rns)


class Decryptor:
    """(decryptor.h:47)"""

    def __init__(self, context: HeContext, secret_key: SecretKey):
        self.context = context
        self._sk = secret_key
        # NTT-form powers of s over the key base, s^1 first
        self._sk_powers: Dict[int, torch.Tensor] = {1: secret_key.data}

    def _sk_power(self, p: int) -> torch.Tensor:
        if p not in self._sk_powers:
            cd = self.context.key_context_data
            self._sk_powers[p] = dntt.rns_dyadic_mul(
                self._sk_power(p - 1), self._sk.data, cd.ntt)
        return self._sk_powers[p]

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        if self.context.scheme != SchemeType.bfv:
            raise NotImplementedError(
                f"{self.context.scheme.name} decryption is not ported yet "
                "(ROADMAP.md, queue 2)")
        cd = self.context.get_context_data(ct.level)
        powers = torch.stack([self._sk_power(p) for p in range(1, ct.size)])
        return Plaintext(data=_decrypt_core(ct.data, powers, cd,
                                            ct.is_ntt_form))
