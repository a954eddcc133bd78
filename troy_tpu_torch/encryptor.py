"""Encryptor: public-key (asymmetric) and secret-key (symmetric) encryption
of BFV, CKKS and BGV plaintexts.

The port of troy_tpu/encryptor.py. A zero encryption (rlwe.py) takes the
plaintext into c0:
  * BFV: a coefficient-form zero encryption whose finish adds round(Q/t *
    m) (kernel DG, the embedding on D's grid; kernel G on the
    host-sampling path);
  * CKKS: an NTT-form zero encryption at the plaintext's level, then
    c0 + m, added in the zero encryption's finish (kernel D);
  * BGV (whose zero encryption's noise is t e): an NTT-form zero
    encryption, then c0 + NTT(m mod q_i), the raw residues without a
    centred lift (kernels G', A, then the finish's D).

By default the zero encryption draws its randomness on the device from
threefry streams (kernel I), the seeds from this encryptor's BLAKE2Xb
stream in the JAX package's order, so a seeded encryptor gives
``troy_tpu``'s words. ``host_sampling=True`` makes symmetric encryption
draw on the host exactly as the reference's host path does (word-equal to
troy's C++ output, and much slower); asymmetric encryption and
``encrypt_zero`` sample on the device either way, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .context import ContextData, HeContext
from .he_types import Ciphertext, Plaintext, PublicKey, SecretKey
from .params import SchemeType
from . import prng as rnd
from . import rlwe
from .ops import poly as dpoly
from .utils import profiling


def _plain_operand(m: torch.Tensor, cd: ContextData) -> torch.Tensor:
    """The NTT-form words an NTT-form encryption adds to c0: CKKS's m;
    BGV's raw residues (the lift with threshold t lifts nothing)
    transformed: on A's route one call (AGp), on J's G' then J."""
    if cd.scheme == SchemeType.ckks:
        return m
    t = int(cd.plain_modulus)
    return dpoly.plain_lift_ntt(m, cd.ntt, t, t, cd.total_coeff_modulus)


def _finish_operand(m: torch.Tensor, cd: ContextData,
                    is_ntt_form: bool) -> torch.Tensor:
    """What the zero encryption's finish takes into c0: the NTT-form words
    (CKKS, BGV), or BFV's words mod t, which DG embeds."""
    return _plain_operand(m, cd) if is_ntt_form else m


def _encrypt_sym_full(seeds: Sequence[int], m: torch.Tensor,
                      sk_data: torch.Tensor, cd: ContextData,
                      is_ntt_form: bool) -> torch.Tensor:
    """A whole symmetric encryption sampled on the device: seeds (a, e)
    (troy_tpu/encryptor.py:52), the plaintext added in the zero
    encryption's finish (D; BFV's embedding on DG)."""
    return rlwe._zero_sym_core(seeds[0], seeds[1], sk_data, cd, is_ntt_form,
                               _finish_operand(m, cd, is_ntt_form))


def _encrypt_sym_batch(a_seeds: torch.Tensor, e_seeds: torch.Tensor,
                       m: torch.Tensor, sk_data: torch.Tensor,
                       cd: ContextData, is_ntt_form: bool) -> torch.Tensor:
    """B symmetric encryptions from device arrays of B seed pairs, (B, 2,
    k, n) (troy_tpu/encryptor.py:113): one launch each of I, B, A and D
    (BFV: DG), the finish writing each c0 and copying each c1 into the
    batch."""
    return rlwe._zero_sym_core(a_seeds, e_seeds, sk_data, cd, is_ntt_form,
                               _finish_operand(m, cd, is_ntt_form))


def _embed_into_zero(zero_data: torch.Tensor, m: torch.Tensor,
                     cd: ContextData) -> torch.Tensor:
    """The plaintext embedded into a zero encryption's c0, a new ciphertext
    (troy_tpu/encryptor.py:29, :63): BFV's c0 + round(Q/t * m) on kernel G,
    the others' c0 + the NTT-form words on D, each one launch that copies
    c1 too. The host-sampling path's."""
    if cd.scheme == SchemeType.bfv:
        return dpoly.bfv_plain_embed_c0(zero_data, m, *rlwe.bfv_embed_args(cd),
                                        cd.ntt)
    return dpoly.rns_add_c0(zero_data, _plain_operand(m, cd), cd.ntt)


def _encrypt_asym_full(seeds: Sequence[int], m: torch.Tensor,
                       pk_data: torch.Tensor, cd: ContextData,
                       is_ntt_form: bool) -> torch.Tensor:
    """A whole asymmetric encryption: seeds (u, e_0, ..., e_{size-1})
    (troy_tpu/encryptor.py:71), the plaintext added as in
    ``_encrypt_sym_full``."""
    return rlwe._zero_asym_core(seeds[0], seeds[1:], pk_data, cd,
                                is_ntt_form,
                                _finish_operand(m, cd, is_ntt_form))


class Encryptor:
    """(encryptor.h:45) A keyless encryptor may be made; the key an
    encryption needs is checked when it is asked for."""

    def __init__(self, context: HeContext,
                 public_key: Optional[PublicKey] = None,
                 secret_key: Optional[SecretKey] = None,
                 seed: Optional[bytes] = None,
                 host_sampling: bool = False):
        self.context = context
        self._pk = public_key
        self._sk = secret_key
        self._host_sampling = host_sampling
        self._prng = rnd.RandomGeneratorFactory.default_factory().create(seed)
        # the public key's components over each level's first k limbs
        self._pk_levels: Dict[int, torch.Tensor] = {}

    # ---- public API (encryptor.h:123-394) ----
    @profiling.spanned("encrypt")
    def encrypt(self, plain: Plaintext) -> Ciphertext:
        """Public-key encryption."""
        return self._encrypt_internal(plain, asymmetric=True, save_seed=False)

    @profiling.spanned("encrypt")
    def encrypt_symmetric(self, plain: Plaintext,
                          save_seed: bool = False) -> Ciphertext:
        """Secret-key encryption; with save_seed the ciphertext's ``seed``
        regenerates its c1 (``rlwe.expand_seed``)."""
        return self._encrypt_internal(plain, asymmetric=False,
                                      save_seed=save_seed)

    @profiling.spanned("encrypt")
    def encrypt_symmetric_many(self, plains: Sequence[Plaintext],
                               save_seed: bool = False) -> List[Ciphertext]:
        """Symmetric encryption of several plaintexts of one form and level
        in one batched pass: one upload of the seeds, one launch per step
        (troy_tpu/encryptor.py:113). With host_sampling, one by one."""
        if self._host_sampling:
            return [self._encrypt_internal(p, asymmetric=False,
                                           save_seed=save_seed)
                    for p in plains]
        plains = list(plains)
        if not plains:
            return []
        if self._sk is None:
            raise ValueError("no secret key set")
        cd, is_ntt = self._plain_cd(plains[0])
        seeds, a_seeds, e_seeds = rlwe.sample_zero_sym_batch(
            cd, self._prng, len(plains))
        m = torch.stack([self._plain_words(p, cd) for p in plains])
        data = _encrypt_sym_batch(a_seeds, e_seeds, m, self._sk.data, cd,
                                  is_ntt)
        scale = plains[0].scale if cd.scheme == SchemeType.ckks else 1.0
        return [Ciphertext(data=data[i], level=cd.chain_index,
                           is_ntt_form=is_ntt, scale=scale,
                           seed=seeds[i] if save_seed else 0)
                for i in range(len(plains))]

    @profiling.spanned("encrypt")
    def encrypt_zero(self, level: Optional[int] = None,
                     asymmetric: bool = True,
                     save_seed: bool = False) -> Ciphertext:
        """An encryption of zero at ``level`` (the first data level by
        default), sampled on the device."""
        cd = (self.context.first_context_data if level is None
              else self.context.get_context_data(level))
        is_ntt = self.context.scheme in (SchemeType.ckks, SchemeType.bgv)
        if asymmetric:
            if self._pk is None:
                raise ValueError("no public key set")
            return rlwe.encrypt_zero_asymmetric(cd, self._pk, self._prng,
                                                is_ntt)
        if self._sk is None:
            raise ValueError("no secret key set")
        return rlwe.encrypt_zero_symmetric(cd, self._sk, self._prng, is_ntt,
                                           save_seed)

    # ---- internals ----
    def _plain_cd(self, plain: Plaintext):
        """(context data, NTT form) of the ciphertext of ``plain``: CKKS at
        the plaintext's level in NTT form; BFV and BGV at the first level,
        BGV in NTT form."""
        scheme = self.context.scheme
        if scheme == SchemeType.ckks:
            if not plain.is_ntt_form or plain.level is None:
                raise ValueError("CKKS plaintext must be NTT form at a level")
            return self.context.get_context_data(plain.level), True
        if plain.is_ntt_form:
            raise ValueError(f"{scheme.name} plaintext must be in "
                             "coefficient form")
        return self.context.first_context_data, scheme == SchemeType.bgv

    @staticmethod
    def _plain_words(plain: Plaintext, cd: ContextData) -> torch.Tensor:
        """The plaintext's words; a coefficient-form one zero-padded to n
        (the reference takes any count <= n)."""
        m = plain.data
        if plain.is_ntt_form or m.shape[-1] == cd.n:
            return m
        if m.shape[-1] > cd.n:
            raise ValueError(f"plaintext has {m.shape[-1]} coefficients "
                             f"> n={cd.n}")
        return torch.nn.functional.pad(m, (0, cd.n - m.shape[-1]))

    def _pk_at(self, k: int) -> torch.Tensor:
        """The public key's components over the first k limbs, contiguous,
        made once per k."""
        if k not in self._pk_levels:
            self._pk_levels[k] = self._pk.data[:, :k].contiguous()
        return self._pk_levels[k]

    def _encrypt_internal(self, plain: Plaintext, asymmetric: bool,
                          save_seed: bool) -> Ciphertext:
        cd, is_ntt = self._plain_cd(plain)
        m = self._plain_words(plain, cd)
        a_seed = 0
        if asymmetric:
            if self._pk is None:
                raise ValueError("no public key set")
            seeds = [self._prng.next_uint64()
                     for _ in range(1 + self._pk.data.shape[0])]
            data = _encrypt_asym_full(seeds, m, self._pk_at(cd.limbs), cd,
                                      is_ntt)
        elif self._host_sampling:
            if self._sk is None:
                raise ValueError("no secret key set")
            if save_seed:
                # the reference's host path has no seed-compressed form
                # (rlwe.cpp:138)
                raise ValueError("save_seed is not supported with "
                                 "host_sampling (c1 is not seed-expanded "
                                 "on this path)")
            zero = rlwe.encrypt_zero_symmetric_reference(
                cd, self._sk, self._prng, is_ntt)
            data = _embed_into_zero(zero.data, m, cd)
        else:
            if self._sk is None:
                raise ValueError("no secret key set")
            a_seed = self._prng.next_uint64() | 1
            e_seed = self._prng.next_uint64()
            data = _encrypt_sym_full((a_seed, e_seed), m, self._sk.data, cd,
                                     is_ntt)
        return Ciphertext(
            data=data, level=cd.chain_index, is_ntt_form=is_ntt,
            scale=plain.scale if cd.scheme == SchemeType.ckks else 1.0,
            seed=a_seed if (save_seed and not asymmetric) else 0)
