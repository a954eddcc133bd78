"""RLWE zero encryptions: the shared core of keygen and the encryptor.

The port of troy_tpu/rlwe.py:
  * symmetric: c = (-(a*s + e), a), a expandable from a stored 64-bit seed;
  * asymmetric: c_j = pk_j * u + e_j with ternary u;
  * BGV noise is scaled by the plain modulus t.

Two ways to draw the randomness. By default every polynomial is drawn on
the device from a threefry stream keyed by a 64-bit seed (kernel I,
ops/sampling.py), word-equal to the JAX package's ``jax.random`` draws, so
one encryption passes two host integers to the card and nothing else, and
a seed-compressed ciphertext expands to the same c1 in either package.
The host-sampling paths draw a and e on the host from the seeded BLAKE2Xb
streams of ``prng.py`` in the reference's exact draw order, so seeded
results are word-equal to troy's C++ host path and to ``troy_tpu``'s.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .context import ContextData
from .he_types import Ciphertext, PublicKey, SecretKey
from .interop import to_torch
from .params import SchemeType
from . import prng as rnd
from .ops import ntt as dntt
from .ops import poly as dpoly
from .ops import sampling
from .ops.sampling import Seeds
from .utils import host_ntt as hntt
from .utils.ntt_tables import make_ntt_tables


# --------------------------------------------------------------------------
# device samplers (kernel I; a seed is a u64 host integer, or a device
# tensor of seeds for the batched cores)
# --------------------------------------------------------------------------

def sample_uniform_rns_dev(seeds: Seeds, cd: ContextData) -> torch.Tensor:
    """(k, n) uniform residues over this level's base (NTT order), or
    (B, k, n) for B seeds (troy_tpu/rlwe.py:57)."""
    return sampling.sample_uniform_rns(seeds, cd.ntt)


def sample_cbd_dev(seeds: Seeds, cd: ContextData) -> torch.Tensor:
    """Centred binomial noise lifted into this level's base, (k, n) or
    (B, k, n); times t for BGV (troy_tpu/rlwe.py:71, :90, :121-122)."""
    return sampling.sample_cbd_rns(seeds, cd.ntt, _noise_scale(cd))


def sample_ternary_dev(seeds: Seeds, cd: ContextData) -> torch.Tensor:
    """Uniform ternary lifted into this level's base (troy_tpu/rlwe.py:83,
    :90)."""
    return sampling.sample_ternary_rns(seeds, cd.ntt)


# --------------------------------------------------------------------------
# symmetric zero encryption
# --------------------------------------------------------------------------

def _noise_scale(cd: ContextData):
    """BGV's t, the factor of every noise draw; None for BFV and CKKS."""
    return int(cd.plain_modulus) if cd.scheme == SchemeType.bgv else None


def bfv_embed_args(cd: ContextData) -> tuple:
    """(t, Q mod t, floor(Q/t) mod q_i): BFV's plain embedding of this
    level (ops/poly.py bfv_plain_embed)."""
    return (int(cd.plain_modulus), cd.coeff_modulus_mod_plain_modulus,
            cd.coeff_div_plain_modulus)


def _lead(seeds: Seeds) -> tuple:
    return () if isinstance(seeds, int) else (seeds.numel(),)


def _zero_sym_ntt_parts(a_seeds: Seeds, e_seeds: Seeds, sk_data: torch.Tensor,
                        cd: ContextData
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The NTT-form zero encryption's parts, (buf, a s, NTT(e)): one
    kernel-I launch draws e into buf[0] and a into buf[1] (buf (2, k, n),
    or (2, B, k, n) for device arrays of B seeds; for one seed pair buf is
    the ciphertext's layout, c0 over e and c1 = a), then B and A."""
    t = cd.ntt
    buf = torch.empty((2,) + _lead(a_seeds) + (cd.limbs, cd.n),
                      dtype=torch.int64, device=cd.device)
    sampling.sample_zero_sym_rns(a_seeds, e_seeds, t, _noise_scale(cd),
                                 buf[0], buf[1])
    as_ntt = dntt.dyadic_mac(sk_data[:cd.limbs].unsqueeze(0),
                             buf[1].unsqueeze(0), t)
    return buf, as_ntt, dntt.rns_ntt_forward(buf[0], t)


def _zero_sym_coeff(a_seeds: Seeds, e_seeds: Seeds, sk_data: torch.Tensor,
                    cd: ContextData,
                    m: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The coefficient-form zero encryption: (2, k, n) (c0, c1), or (2, B,
    k, n) (the c0s, then the c1s) for B seed pairs. One kernel-I launch
    draws e and a around a free slot that B fills with a s, so both
    inverse transforms are one launch on contiguous rows, and the finish
    writes c0 = -(a s + e) over the transformed a s. With BFV's plaintexts
    ``m`` ((n,), or (B, n) mod t) the finish is DG's, c0 = round(Q m / t) -
    (a s + e), and B seed pairs give (B, 2, k, n): the finish writes each
    c0 and copies each c1 into the ciphertexts."""
    t = cd.ntt
    buf = torch.empty((3,) + _lead(a_seeds) + (cd.limbs, cd.n),
                      dtype=torch.int64, device=cd.device)
    sampling.sample_zero_sym_rns(a_seeds, e_seeds, t, _noise_scale(cd),
                                 buf[0], buf[2])
    dntt.dyadic_mac(sk_data[:cd.limbs].unsqueeze(0), buf[2].unsqueeze(0), t,
                    out=buf[1])
    both = dntt.rns_ntt_inverse(buf[1:], t)
    if m is None:
        dpoly.zero_sym_finish(both[0], buf[0], t, out=both[0])
        return both
    args = bfv_embed_args(cd)
    if isinstance(a_seeds, int):
        dpoly.zero_sym_embed(both[0], buf[0], m, *args, t, out=both[0])
        return both
    ct = torch.empty(_lead(a_seeds) + (2, cd.limbs, cd.n), dtype=torch.int64,
                     device=cd.device)
    dpoly.zero_sym_embed(both[0], buf[0], m, *args, t, out=ct[:, 0],
                         c1=both[1])
    return ct


def _zero_sym_core(a_seeds: Seeds, e_seeds: Seeds, sk_data: torch.Tensor,
                   cd: ContextData, is_ntt_form: bool,
                   m: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric zero encryption sampled on the device, (2, k, n), or
    (B, 2, k, n) for device arrays of B seed pairs, the same words as B
    single draws (troy_tpu/rlwe.py:111 _zero_sym_core, :260
    _zero_sym_batch_core): c = (-(a s + e), a). ``m``, the plaintext, joins
    c0 in the same finish: in NTT form its NTT-form words (c0's shape),
    added by D; in coefficient form (BFV) its words mod t ((n,), or (B, n)),
    embedded as round(Q m / t) by DG. One launch each of I, B, A and D (or
    DG), and for one seed pair no copy (the draw's buffer is the
    ciphertext). A coefficient-form batch needs its plaintexts."""
    if not is_ntt_form:
        if m is not None and cd.scheme != SchemeType.bfv:
            raise ValueError("_zero_sym_core: a coefficient-form plaintext "
                             "is BFV's")
        if m is None and not isinstance(a_seeds, int):
            raise ValueError("_zero_sym_core: a coefficient-form batch "
                             "needs its plaintexts")
        return _zero_sym_coeff(a_seeds, e_seeds, sk_data, cd, m)
    buf, as_ntt, e_ntt = _zero_sym_ntt_parts(a_seeds, e_seeds, sk_data, cd)
    if isinstance(a_seeds, int):
        dpoly.zero_sym_finish(as_ntt, e_ntt, cd.ntt, m, out=buf[0])
        return buf
    ct = torch.empty(_lead(a_seeds) + (2, cd.limbs, cd.n), dtype=torch.int64,
                     device=cd.device)
    dpoly.zero_sym_finish(as_ntt, e_ntt, cd.ntt, m, out=ct[:, 0], c1=buf[1])
    return ct


def encrypt_zero_symmetric(cd: ContextData, sk: SecretKey,
                           generator: rnd.UniformRandomGenerator,
                           is_ntt_form: bool,
                           save_seed: bool = False) -> Ciphertext:
    """Symmetric encryption of zero at level cd (troy_tpu/rlwe.py:233):
    c0 + c1 s = -e (-t e for BGV). With save_seed the ciphertext's
    ``seed`` regenerates c1."""
    a_seed = generator.next_uint64() | 1     # nonzero marker
    e_seed = generator.next_uint64()
    data = _zero_sym_core(a_seed, e_seed, sk.data, cd, is_ntt_form)
    return Ciphertext(data=data, level=cd.chain_index,
                      is_ntt_form=is_ntt_form,
                      seed=a_seed if save_seed else 0)


def sample_zero_sym_batch(cd: ContextData,
                          generator: rnd.UniformRandomGenerator,
                          count: int) -> Tuple[List[int], torch.Tensor,
                                               torch.Tensor]:
    """Host side of a batched symmetric encryption (troy_tpu/rlwe.py:272):
    the a-seeds as integers, then the a- and e-seeds on the device (every
    a-seed is drawn before any e-seed), uploaded together."""
    a_seeds = [generator.next_uint64() | 1 for _ in range(count)]
    e_seeds = [generator.next_uint64() for _ in range(count)]
    both = to_torch(np.array(a_seeds + e_seeds, dtype=np.uint64), cd.device)
    return a_seeds, both[:count], both[count:]


def _expand_seed_core(data: torch.Tensor, a_seed: int, cd: ContextData,
                      is_ntt_form: bool) -> torch.Tensor:
    """data with c1 regenerated from its seed (troy_tpu/rlwe.py:284)."""
    a = sample_uniform_rns_dev(a_seed, cd)
    if not is_ntt_form:
        a = dntt.rns_ntt_inverse(a, cd.ntt)
    return torch.cat([data[:1], a.unsqueeze(0), data[2:]])


def expand_seed(ct: Ciphertext, cd: ContextData) -> Ciphertext:
    """Regenerate c1 of a seed-compressed symmetric ciphertext
    (troy_tpu/rlwe.py:292): the same threefry draw as the encryption."""
    if ct.seed == 0:
        return ct
    data = _expand_seed_core(ct.data, ct.seed, cd, ct.is_ntt_form)
    return ct.replace(data=data, seed=0)


# --------------------------------------------------------------------------
# asymmetric zero encryption
# --------------------------------------------------------------------------

def _zero_asym_core(u_seed: int, e_seeds: Sequence[int],
                    pk_data: torch.Tensor, cd: ContextData,
                    is_ntt_form: bool,
                    m: Optional[torch.Tensor] = None) -> torch.Tensor:
    """c_j = pk_j u + e_j, j < len(e_seeds), with ternary u and CBD e_j
    drawn on the device in one kernel-I launch (troy_tpu/rlwe.py:307):
    (size, k, n). BFV takes the products out of the NTT domain before
    adding e_j, and ``m`` (its words mod t, (n,)) joins c_0 as round(Q m /
    t) in the same finish (DG); CKKS and BGV transform u and every e_j in
    one launch and add NTT(e_j), and ``m`` (NTT-form words, (k, n)) onto
    c_0, in the same finish (D). pk_data: the key's components over at
    least this level's k limbs."""
    t = cd.ntt
    draws = sampling.sample_zero_asym_rns(u_seed, e_seeds, t,
                                          _noise_scale(cd))
    pk = pk_data[:len(e_seeds), :cd.limbs].unsqueeze(0)
    if is_ntt_form:
        d = dntt.rns_ntt_forward(draws, t)
        prods = dntt.dyadic_mac(d[:1], pk, t)
        return dpoly.zero_asym_finish(prods, d[1:], t, m, out=prods)
    if m is not None and cd.scheme != SchemeType.bfv:
        raise ValueError("_zero_asym_core: a coefficient-form plaintext is "
                         "BFV's")
    u_ntt = dntt.rns_ntt_forward(draws[:1], t)
    prods = dntt.rns_ntt_inverse(dntt.dyadic_mac(u_ntt, pk, t), t)
    if m is None:
        return dpoly.zero_asym_finish(prods, draws[1:], t, out=prods)
    return dpoly.zero_asym_embed(prods, draws[1:], m, *bfv_embed_args(cd), t,
                                 out=prods)


def encrypt_zero_asymmetric(cd: ContextData, pk: PublicKey,
                            generator: rnd.UniformRandomGenerator,
                            is_ntt_form: bool) -> Ciphertext:
    """Asymmetric encryption of zero at level cd (troy_tpu/rlwe.py:332):
    the seeds are u's, then one e-seed per component."""
    size = pk.data.shape[0]
    u_seed = generator.next_uint64()
    e_seeds = [generator.next_uint64() for _ in range(size)]
    data = _zero_asym_core(u_seed, e_seeds, pk.data, cd, is_ntt_form)
    return Ciphertext(data=data, level=cd.chain_index,
                      is_ntt_form=is_ntt_form)


# --------------------------------------------------------------------------
# host sampling (the reference's BLAKE2Xb draw order)
# --------------------------------------------------------------------------


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
    return torch.stack([dpoly.zero_sym_finish(nz, c0, t), c1])


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
