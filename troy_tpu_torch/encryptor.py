"""Encryptor: symmetric (secret-key) BFV, CKKS and BGV encryption with
host sampling.

The port of troy_tpu/encryptor.py, symmetric path with
``host_sampling=True``: the zero encryption draws its randomness on the
host exactly as the reference's host path does (so seeded ciphertexts are
word-equal to troy's and to ``troy_tpu``'s), then the plaintext is embedded
into c0: BFV as c0 + round(Q/t * m) in the coefficient domain (kernel G),
CKKS as c0 + m in the NTT domain at the plaintext's level (kernel D), BGV
(whose zero encryption's noise is t e) as c0 + NTT(m mod q_i) in the NTT
domain, the raw residues without a centred lift (kernels G', A, D).
"""

from __future__ import annotations

from typing import Optional

import torch

from .context import ContextData, HeContext
from .he_types import Ciphertext, Plaintext, SecretKey
from .params import SchemeType
from . import prng as rnd
from . import rlwe
from .ops import ntt as dntt
from .ops import poly as dpoly

_LATER = ("is not ported yet (ROADMAP.md, queue 2: device sampling and "
          "asymmetric encryption)")


def _embed_plain_c0(m: torch.Tensor, c0: torch.Tensor,
                    cd: ContextData) -> torch.Tensor:
    """BFV: c0 += round(Q/t * m) (multiplyAddPlainWithScalingVariant)."""
    return dpoly.bfv_plain_embed(
        m, c0, int(cd.plain_modulus), cd.coeff_modulus_mod_plain_modulus,
        cd.coeff_div_plain_modulus, cd.ntt)


class Encryptor:
    """(encryptor.h:45)"""

    def __init__(self, context: HeContext,
                 secret_key: Optional[SecretKey] = None,
                 seed: Optional[bytes] = None,
                 host_sampling: bool = False):
        if not host_sampling:
            raise NotImplementedError(f"device sampling {_LATER}")
        self.context = context
        self._sk = secret_key
        self._prng = rnd.RandomGeneratorFactory.default_factory().create(seed)

    def encrypt_symmetric(self, plain: Plaintext) -> Ciphertext:
        scheme = self.context.scheme
        if self._sk is None:
            raise ValueError("no secret key set")
        if scheme == SchemeType.ckks:
            return self._encrypt_ckks(plain)
        if plain.is_ntt_form:
            raise ValueError(f"{scheme.name} plaintext must be in "
                             "coefficient form")
        cd = self.context.first_context_data
        m = plain.data
        if m.shape[-1] > cd.n:
            raise ValueError(f"plaintext has {m.shape[-1]} coefficients "
                             f"> n={cd.n}")
        if m.shape[-1] < cd.n:
            m = torch.nn.functional.pad(m, (0, cd.n - m.shape[-1]))
        bgv = scheme == SchemeType.bgv
        zero = rlwe.encrypt_zero_symmetric_reference(cd, self._sk, self._prng,
                                                     is_ntt_form=bgv)
        if bgv:
            # the raw residues: plain_lift with threshold t lifts nothing
            # (troy_tpu/encryptor.py:40-48)
            t = int(cd.plain_modulus)
            lifted = dpoly.plain_lift(m, cd.ntt, t, t, cd.total_coeff_modulus)
            c0 = dpoly.rns_add(zero.data[0],
                               dntt.rns_ntt_forward(lifted, cd.ntt), cd.ntt)
        else:
            c0 = _embed_plain_c0(m, zero.data[0], cd)
        return zero.replace(data=torch.stack([c0, zero.data[1]]))

    def _encrypt_ckks(self, plain: Plaintext) -> Ciphertext:
        """An NTT-form zero encryption at the plaintext's level, then
        c0 += m (troy_tpu/encryptor.py:38-39); the result carries the
        plaintext's scale."""
        if not plain.is_ntt_form or plain.level is None:
            raise ValueError("CKKS plaintext must be NTT form at a level")
        cd = self.context.get_context_data(plain.level)
        zero = rlwe.encrypt_zero_symmetric_reference(cd, self._sk, self._prng,
                                                     is_ntt_form=True)
        c0 = dpoly.rns_add(zero.data[0], plain.data, cd.ntt)
        return zero.replace(data=torch.stack([c0, zero.data[1]]),
                            scale=plain.scale)
