"""The explicit-argument evaluator API: plain functions of ciphertexts,
tensors and ContextData.

The port of troy_tpu/functional.py. Every function takes its ciphertexts,
its keys' tensors and the ContextData of its level (and of the key level)
as arguments, holds no state and caches nothing, and runs the same cores
as ``Evaluator`` (evaluator.py), so it launches the same kernels. The JAX
package's reason for this surface, tracing a whole pipeline into one
``jax.jit`` program, does not carry over: PyTorch runs eagerly. What it
gives here is a pipeline with no hidden state whose launches depend only
on its arguments, which is what a CUDA graph capture
(``torch.cuda.graphs``) needs:

    from troy_tpu_torch import functional as F

    def step(ct1, ct2, cd, key_cd, rk2):
        return F.mod_switch_to_next(
            F.multiply_relinearize(ct1, ct2, rk2, cd, key_cd), cd)

    out = step(ct1, ct2, ctx.first_context_data, ctx.key_context_data,
               relin_keys.keys[2])

Unlike ``Evaluator``, ``add`` and ``sub`` take operands of one size and
one correction factor (BGV balancing is host logic; balance first).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .context import ContextData
from .he_types import Ciphertext
from .params import SchemeType
from .ops import galois as dgalois
from .ops import keyswitch as dks
from .ops import poly as dpoly
from .ops import rns as drns
from . import evaluator as _ev


def negate(ct: Ciphertext, cd: ContextData) -> Ciphertext:
    return ct.replace(data=dpoly.rns_neg(ct.data, cd.ntt))


def add(a: Ciphertext, b: Ciphertext, cd: ContextData) -> Ciphertext:
    """Same size, same metadata (kernel D)."""
    return a.replace(data=dpoly.rns_add(a.data, b.data, cd.ntt))


def sub(a: Ciphertext, b: Ciphertext, cd: ContextData) -> Ciphertext:
    return a.replace(data=dpoly.rns_sub(a.data, b.data, cd.ntt))


def _product(a: Ciphertext, data: torch.Tensor, scale: float, cf: int,
             cd: ContextData) -> Ciphertext:
    if cd.scheme == SchemeType.ckks:
        return a.replace(data=data, scale=scale)
    if cd.scheme == SchemeType.bgv:
        return a.replace(data=data,
                         correction_factor=cf % int(cd.plain_modulus))
    return a.replace(data=data)


def multiply(a: Ciphertext, b: Ciphertext, cd: ContextData) -> Ciphertext:
    """BEHZ (BFV, coefficient form) or the NTT-domain convolution (CKKS,
    BGV); size s1 + s2 - 1."""
    if cd.scheme == SchemeType.bfv:
        data = _ev._bfv_multiply(a.data, b.data, cd)
    else:
        data = _ev._dyadic_convolution(a.data, b.data, cd.ntt)
    return _product(a, data, a.scale * b.scale,
                    a.correction_factor * b.correction_factor, cd)


def square(a: Ciphertext, cd: ContextData) -> Ciphertext:
    """BFV's one-lift square; CKKS and BGV the convolution with itself
    (``Evaluator.square``)."""
    if cd.scheme == SchemeType.bfv:
        data = _ev._bfv_multiply(a.data, None, cd)
    else:
        data = _ev._dyadic_convolution(a.data, a.data, cd.ntt)
    return _product(a, data, a.scale * a.scale,
                    a.correction_factor * a.correction_factor, cd)


def switch_key(target: torch.Tensor, key: torch.Tensor, cd: ContextData,
               key_cd: ContextData, target_ntt_form: bool) -> torch.Tensor:
    """The key switch of a target (k, n) under a dense key (decomp, 2,
    key_limbs, n): (2, k, n) in the target's domain (evaluator_cuda.cu:
    1163-1362)."""
    return _ev._switch_key_core(target, key, cd, key_cd,
                                ntt_form=target_ntt_form)


def relinearize(ct: Ciphertext, keys: Sequence[torch.Tensor],
                cd: ContextData, key_cd: ContextData) -> Ciphertext:
    """Size 2 + len(keys) -> 2; ``keys[i]`` is the dense key of power
    i + 2 (``relin_keys.keys[i + 2]``)."""
    if ct.size == 2:
        return ct
    if len(keys) != ct.size - 2:
        raise ValueError(f"need {ct.size - 2} relin key arrays, got "
                         f"{len(keys)}")
    return ct.replace(data=_ev._relinearize_core(
        ct.data, tuple(keys), cd, key_cd, ct.is_ntt_form))


def multiply_relinearize(a: Ciphertext, b: Ciphertext, rk2: torch.Tensor,
                         cd: ContextData, key_cd: ContextData) -> Ciphertext:
    """The benchmark op: multiply, then relinearize with keys[2]."""
    return relinearize(multiply(a, b, cd), (rk2,), cd, key_cd)


def mod_switch_to_next(ct: Ciphertext, cd: ContextData) -> Ciphertext:
    """BFV divides by the level's last prime (K), CKKS drops it, BGV
    divides in the NTT domain (A, K'-BGV) with the correction factor times
    q_last^-1 mod t (``Evaluator.mod_switch_to_next``)."""
    level = ct.level + 1
    if cd.scheme == SchemeType.ckks:
        return ct.replace(data=ct.data[:, :-1], level=level)
    if cd.scheme == SchemeType.bgv:
        data = drns.mod_t_and_divide_q_last_ntt(ct.data, cd.ntt,
                                                cd.bgv_mod_switch_consts)
        cf = (ct.correction_factor * cd.rns_tool.inv_q_last_mod_t
              % int(cd.plain_modulus))
        return ct.replace(data=data, level=level, correction_factor=cf)
    return ct.replace(data=dks.divide_and_round_q_last(ct.data, cd.ntt),
                      level=level)


def rescale_to_next(ct: Ciphertext, cd: ContextData) -> Ciphertext:
    """CKKS: divide by the level's last prime in the NTT domain (A, K')."""
    if cd.scheme != SchemeType.ckks:
        raise ValueError("rescale is CKKS-only")
    data = drns.divide_and_round_q_last_ntt(ct.data, cd.ntt,
                                            cd.rescale_consts)
    return ct.replace(data=data, level=ct.level + 1,
                      scale=ct.scale / cd.coeff_values[-1])


def apply_galois(ct: Ciphertext, perm: torch.Tensor, key: torch.Tensor,
                 cd: ContextData, key_cd: ContextData) -> Ciphertext:
    """The automorphism of an NTT-form size-2 ciphertext: both components
    gathered by ``perm`` (``ops.galois.ntt_permutation(n, elt, device)``,
    kernel M), c1 key-switched by the element's dense key and added onto
    the permuted c0."""
    if not ct.is_ntt_form:
        raise ValueError("functional apply_galois expects NTT form "
                         "(use apply_galois_coeff)")
    permuted = dgalois.apply_permutation(ct.data, perm)
    return ct.replace(data=_ev._switch_key_core(
        permuted[1], key, cd, key_cd, acc=permuted[:1], ntt_form=True))


def apply_galois_coeff(ct: Ciphertext, src: torch.Tensor,
                       keep_sign: torch.Tensor, key: torch.Tensor,
                       cd: ContextData, key_cd: ContextData) -> Ciphertext:
    """The automorphism of a coefficient-form size-2 ciphertext: the
    signed permutation of ``ops.galois.coeff_permutation(n, elt, device)``
    (kernel M), then the key switch in the coefficient domain."""
    if ct.is_ntt_form:
        raise ValueError("functional apply_galois_coeff expects "
                         "coefficient form (use apply_galois)")
    permuted = dgalois.apply_permutation_signed(ct.data, src, keep_sign,
                                                cd.ntt)
    return ct.replace(data=_ev._switch_key_core(
        permuted[1], key, cd, key_cd, acc=permuted[:1], ntt_form=False))
