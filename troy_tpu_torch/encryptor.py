"""Encryptor: symmetric (secret-key) BFV encryption with host sampling.

The port of troy_tpu/encryptor.py, BFV symmetric path with
``host_sampling=True``: the zero encryption draws its randomness on the
host exactly as the reference's host path does (so seeded ciphertexts are
word-equal to troy's and to ``troy_tpu``'s), then the plaintext is embedded
into c0 as c0 + round(Q/t * m).
"""

from __future__ import annotations

from typing import Optional

import torch

from .context import ContextData, HeContext
from .he_types import Ciphertext, Plaintext, SecretKey
from .params import SchemeType
from . import prng as rnd
from . import rlwe
from .ops import poly as dpoly

_LATER = ("is not ported yet (ROADMAP.md, queue 2: device sampling, "
          "asymmetric encryption, BGV and CKKS)")


def _embed_plain_c0(m: torch.Tensor, c0: torch.Tensor,
                    cd: ContextData) -> torch.Tensor:
    """BFV: c0 += round(Q/t * m) (multiplyAddPlainWithScalingVariant)."""
    return dpoly.bfv_multiply_add_plain(
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
        if self.context.scheme != SchemeType.bfv:
            raise NotImplementedError(
                f"{self.context.scheme.name} encryption {_LATER}")
        if self._sk is None:
            raise ValueError("no secret key set")
        if plain.is_ntt_form:
            raise ValueError("BFV plaintext must be in coefficient form")
        cd = self.context.first_context_data
        m = plain.data
        if m.shape[-1] > cd.n:
            raise ValueError(f"plaintext has {m.shape[-1]} coefficients "
                             f"> n={cd.n}")
        m = torch.nn.functional.pad(m, (0, cd.n - m.shape[-1]))
        zero = rlwe.encrypt_zero_symmetric_reference(cd, self._sk, self._prng,
                                                     is_ntt_form=False)
        c0 = _embed_plain_c0(m, zero.data[0], cd)
        return zero.replace(data=torch.stack([c0, zero.data[1]]))
