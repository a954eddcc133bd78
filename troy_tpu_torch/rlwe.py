"""RLWE symmetric zero encryptions: the shared core of keygen and encryption.

The port of troy_tpu/rlwe.py, host-sampling paths only: c = (-(a*s + e), a)
with a and e drawn on the host from the seeded BLAKE2Xb streams of
``prng.py`` in the reference's exact draw order, so seeded results are
word-equal to troy's C++ host path and to ``troy_tpu``. Device sampling
(the JAX package's threefry streams) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import ContextData
from .he_types import Ciphertext, SecretKey
from .interop import to_torch
from .params import SchemeType
from . import prng as rnd
from .ops import ntt as dntt
from .ops import poly as dpoly
from .utils import host_ntt as hntt
from .utils.ntt_tables import make_ntt_tables


def _zero_sym_reference_core(c1_ntt: torch.Tensor, noise: torch.Tensor,
                             sk_data: torch.Tensor, cd: ContextData,
                             is_ntt_form: bool) -> torch.Tensor:
    """Assemble (-(a*s + e), a) from host-sampled a (NTT domain) and
    centered-lifted noise, in the reference's operation order
    (rlwe.cpp:110-180 encryptZeroSymmetric)."""
    t = cd.ntt
    c0 = dntt.rns_dyadic_mul(sk_data[:cd.limbs], c1_ntt, t)
    t_plain = int(cd.plain_modulus) if cd.scheme == SchemeType.bgv else 1
    if is_ntt_form:
        nz = dntt.rns_ntt_forward(noise, t)
        c1 = c1_ntt
    else:
        c0 = dntt.rns_ntt_inverse(c0, t)
        nz = noise
        c1 = dntt.rns_ntt_inverse(c1_ntt, t)
    if t_plain != 1:
        nz = dpoly.rns_broadcast_scalar_mul(nz, t_plain, t)
    c0 = dpoly.rns_neg(dpoly.rns_add(nz, c0, t), t)
    return torch.stack([c0, c1])


def encrypt_zero_symmetric_reference(
        cd: ContextData,
        sk: SecretKey,
        generator: rnd.UniformRandomGenerator,
        is_ntt_form: bool,
) -> Ciphertext:
    """Symmetric zero encryption that consumes the PRNG stream exactly like
    the reference's host path (rlwe.cpp:110 encryptZeroSymmetric: a 64-byte
    public seed for the uniform-a PRNG, then CBD noise from the bootstrap
    stream); the arithmetic runs on the context's device."""
    n = cd.n
    mods = list(cd.coeff_values)
    public_seed = generator.generate(rnd.PRNG_SEED_BYTES)
    ct_prng = rnd.UniformRandomGenerator(public_seed)
    c1_ntt = to_torch(rnd.sample_poly_uniform(ct_prng, n, mods), cd.device)
    noise = to_torch(
        rnd.centered_to_rns(rnd.sample_poly_cbd(generator, n), mods),
        cd.device)
    data = _zero_sym_reference_core(c1_ntt, noise, sk.data, cd, is_ntt_form)
    return Ciphertext(data=data, level=cd.chain_index,
                      is_ntt_form=is_ntt_form)


def encrypt_zero_symmetric_host_np(
        cd: ContextData,
        sk_np: np.ndarray,
        generator: rnd.UniformRandomGenerator,
        is_ntt_form: bool,
) -> np.ndarray:
    """The same zero encryption wholly on the host (numpy in, numpy out):
    the keygen path. Same draw order and the same canonical arithmetic
    (utils/host_ntt twins the transforms word for word)."""
    n = cd.n
    mods = list(cd.coeff_values)
    k = len(mods)
    public_seed = generator.generate(rnd.PRNG_SEED_BYTES)
    ct_prng = rnd.UniformRandomGenerator(public_seed)
    c1_ntt = rnd.sample_poly_uniform(ct_prng, n, mods)       # (k, n) NTT
    noise = rnd.centered_to_rns(rnd.sample_poly_cbd(generator, n), mods)
    c0 = hntt.rns_dyadic_mul_np(sk_np[:k], c1_ntt, n, mods)
    t_plain = int(cd.plain_modulus) if cd.scheme == SchemeType.bgv else 1
    if is_ntt_form:
        nz = hntt.rns_ntt_forward_np(noise, n, mods)
        c1 = c1_ntt
    else:
        c0 = hntt.rns_ntt_inverse_np(c0, n, mods)
        nz = noise
        c1 = hntt.rns_ntt_inverse_np(c1_ntt, n, mods)
    for i, q in enumerate(mods):
        nz_i = nz[i]
        if t_plain != 1:
            cr = make_ntt_tables(n, int(q)).const_ratio
            nz_i = hntt.mul_mod(nz_i, np.uint64(t_plain % q), int(q), cr)
        c0[i] = hntt.neg_mod(hntt.add_mod(nz_i, c0[i], int(q)), int(q))
    return np.stack([c0, c1])
