"""Key generation: secret and public keys, relinearization, Galois and
key-switching keys.

The port of troy_tpu/keygen.py. Like the reference (keygenerator_cuda.cuh:
51-85 wraps a host key generator), keys from a generated secret key are
computed in numpy by default (utils/host_ntt twins the transforms word for
word) and uploaded once, as one finished tensor, to the context's device.
An external secret key (``secret_key=``) lives only on the device, so its
keys are made there: the zero encryptions sampled by kernel I and the
switching key's rows with their P*w terms written by kernel D
(``_kswitch_key_core``, kernel Q).

Switching keys use the dense layout (decomp, 2, key_limbs, n): the j-th
decomposition ciphertext is a fresh symmetric zero encryption over the
full key base whose c0 gets P*w (P = the special prime) added on limb j
only (keygenerator.cpp:294-338).
"""

from __future__ import annotations

import secrets
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .context import ContextData, HeContext
from .he_types import GaloisKeys, KSwitchKeys, PublicKey, RelinKeys, SecretKey
from .interop import to_torch
from . import prng as rnd
from . import rlwe
from .ops import galois as dgalois
from .ops import ntt as dntt
from .ops import poly as dpoly
from .utils import galois as galois_util
from .utils import host_ntt as hntt
from .utils import profiling
from .utils.ntt_tables import make_ntt_tables


def _add_special_terms(c0: torch.Tensor, c1: torch.Tensor,
                       w_ntt: torch.Tensor,
                       key_cd: ContextData) -> torch.Tensor:
    """The key (decomp, 2, key_limbs, n) from decomp finished zero
    encryptions (c0, c1), each (decomp, key_limbs, n), with P*w_j mod q_j
    added onto c0's limb j of row j: one kernel-D Shoup product over the
    decomp limbs, then one D add per row, written into the stacked key
    (keygenerator.cpp:294-338). The host-sampling rows' path."""
    decomp = c0.shape[0]
    key_t = key_cd.ntt
    p_special = key_cd.coeff_values[-1]
    term = dpoly.rns_broadcast_scalar_mul(w_ntt[:decomp].contiguous(),
                                          p_special, key_t.slice(0, decomp))
    out = torch.stack([c0, c1], dim=1)
    for j in range(decomp):
        dpoly.rns_add(c0[j, j:j + 1], term[j:j + 1], key_t.slice(j, j + 1),
                      out=out[j, 0, j:j + 1])
    return out


def _kswitch_key_core(a_seeds: torch.Tensor, e_seeds: torch.Tensor,
                      w_ntt: torch.Tensor, sk_data: torch.Tensor,
                      key_cd: ContextData) -> torch.Tensor:
    """Switching-key generation on the device (troy_tpu/keygen.py:34, kernel
    Q): decomp symmetric zero encryptions over the full key base from (decomp,)
    device seed pairs in one batched pass (one launch each of I, B and A),
    then one kernel-D launch writing the key with P*w on c0's limb j of row
    j. w_ntt: (>= decomp, n) NTT-form target over the key base prefix."""
    buf, as_ntt, e_ntt = rlwe._zero_sym_ntt_parts(a_seeds, e_seeds, sk_data,
                                                   key_cd)
    return dpoly.switching_key_rows(as_ntt, e_ntt, buf[1], w_ntt,
                                    key_cd.coeff_values[-1], key_cd.ntt)


class KeyGenerator:
    """(keygenerator.h:27)

    ``secret_key`` makes the keys of an external secret key (its NTT-form
    words on the device); otherwise a ternary key is drawn from the seed
    stream. ``host_sampling=True`` makes every switching-key row consume a
    fresh replay of the seed stream, as the reference's seeded factory does
    (randomgen.h:419-427, keygenerator.cpp:294-338), so seeded keys are
    word-equal to the reference's. Otherwise the rows draw one after
    another from a single stream: on the host for a generated key, from
    device threefry streams (kernel I) for an external one."""

    @profiling.spanned("keygen")
    def __init__(self, context: HeContext,
                 secret_key: Optional[SecretKey] = None,
                 seed: Optional[bytes] = None,
                 host_sampling: bool = False):
        self.context = context
        if seed is None and host_sampling:
            seed = secrets.token_bytes(rnd.PRNG_SEED_BYTES)
        self._seed = seed
        self._host_sampling = host_sampling
        self._prng = rnd.RandomGeneratorFactory.default_factory().create(seed)
        self._sk_np: Optional[np.ndarray] = None
        if secret_key is not None:
            self._secret_key = secret_key
        else:
            self._sk_np = self._generate_sk_np()
            self._secret_key = SecretKey(data=to_torch(self._sk_np,
                                                       context.device))
        # NTT-domain powers of s over the key base: powers[p] = s^p
        self._sk_powers: Dict[int, torch.Tensor] = {1: self._secret_key.data}
        self._sk_powers_np: Dict[int, np.ndarray] = (
            {1: self._sk_np} if self._sk_np is not None else {})

    def _fresh_gen(self) -> rnd.UniformRandomGenerator:
        """A replay of the seed stream (reference factory create())."""
        return rnd.UniformRandomGenerator(self._seed)

    def _generate_sk_np(self) -> np.ndarray:
        """Ternary secret, NTT form over the key base
        (keygenerator.cpp generateSk)."""
        cd = self.context.key_context_data
        s = rnd.sample_poly_ternary(self._prng, cd.n)
        s_rns = rnd.centered_to_rns(s, cd.coeff_values)
        return hntt.rns_ntt_forward_np(s_rns, cd.n, cd.coeff_values)

    @property
    def secret_key(self) -> SecretKey:
        return self._secret_key

    @profiling.spanned("keygen")
    def create_public_key(self, save_seed: bool = False) -> PublicKey:
        """An NTT-form zero encryption at the key level
        (keygenerator.cpp generatePk): the reference's replay with
        ``host_sampling``; on the host for a generated key; on the device
        (kernel I) with ``save_seed`` (its c1 regenerates from the seed) or
        an external key."""
        cd = self.context.key_context_data
        if self._host_sampling:
            ct = rlwe.encrypt_zero_symmetric_reference(
                cd, self._secret_key, self._fresh_gen(), is_ntt_form=True)
        elif self._sk_np is not None and not save_seed:
            data = rlwe.encrypt_zero_symmetric_host_np(
                cd, self._sk_np, self._prng, is_ntt_form=True)
            return PublicKey(data=to_torch(data, cd.device))
        else:
            ct = rlwe.encrypt_zero_symmetric(
                cd, self._secret_key, self._prng, is_ntt_form=True,
                save_seed=save_seed)
        return PublicKey(data=ct.data, seed=ct.seed)

    def _sk_power(self, p: int) -> torch.Tensor:
        """s^p in the NTT domain on the device (kernel B)."""
        if p not in self._sk_powers:
            cd = self.context.key_context_data
            self._sk_powers[p] = dntt.rns_dyadic_mul(
                self._sk_power(p - 1), self._secret_key.data, cd.ntt)
        return self._sk_powers[p]

    def _sk_power_np(self, p: int) -> np.ndarray:
        if p not in self._sk_powers_np:
            cd = self.context.key_context_data
            self._sk_powers_np[p] = hntt.rns_dyadic_mul_np(
                self._sk_power_np(p - 1), self._sk_np, cd.n, cd.coeff_values)
        return self._sk_powers_np[p]

    def _kswitch_key_host(self, w_ntt_np: np.ndarray) -> torch.Tensor:
        """decomp zero encryptions plus the P*w term on c0's limb j of row
        j, all in numpy, uploaded once (keygenerator.cpp:294-338)."""
        key_cd = self.context.key_context_data
        key_values = key_cd.coeff_values
        n = key_cd.n
        p_special = key_values[-1]
        rows = []
        for j in range(len(key_values) - 1):
            gen = self._fresh_gen() if self._host_sampling else self._prng
            zero = rlwe.encrypt_zero_symmetric_host_np(
                key_cd, self._sk_np, gen, is_ntt_form=True)
            qj = int(key_values[j])
            cr = make_ntt_tables(n, qj).const_ratio
            term = hntt.mul_mod(w_ntt_np[j], np.uint64(p_special % qj),
                                qj, cr)
            zero[0, j] = hntt.add_mod(zero[0, j], term, qj)
            rows.append(zero)
        return to_torch(np.stack(rows), key_cd.device)

    def _generate_one_kswitch_key(self, w_ntt) -> torch.Tensor:
        """The dense key (decomp, 2, key_limbs, n) switching the NTT-form
        target w_ntt (>= decomp rows over the key base prefix; numpy words
        for the host path, a device tensor otherwise) to s
        (troy_tpu/keygen.py:178-210)."""
        ctx = self.context
        if not ctx.using_keyswitching:
            raise ValueError("parameters do not support keyswitching "
                             "(need >= 2 coefficient moduli)")
        key_cd = ctx.key_context_data
        decomp = key_cd.limbs - 1
        if self._sk_np is not None and isinstance(w_ntt, np.ndarray):
            return self._kswitch_key_host(w_ntt)
        if self._host_sampling:
            # the reference's per-row replay, computed on the device
            zeros = torch.stack([rlwe.encrypt_zero_symmetric_reference(
                key_cd, self._secret_key, self._fresh_gen(),
                is_ntt_form=True).data for _ in range(decomp)])
            return _add_special_terms(zeros[:, 0], zeros[:, 1], w_ntt, key_cd)
        _, a_seeds, e_seeds = rlwe.sample_zero_sym_batch(key_cd, self._prng,
                                                          decomp)
        return _kswitch_key_core(a_seeds, e_seeds, w_ntt,
                                 self._secret_key.data, key_cd)

    @profiling.spanned("keygen")
    def create_relin_keys(self, count: int = 1) -> RelinKeys:
        """Keys switching s^p -> s for p = 2 .. count+1
        (keygenerator.cpp:122)."""
        if count < 1 or count > 14:  # SEAL_CIPHERTEXT_SIZE_MAX - 2
            raise ValueError("invalid count")
        power = self._sk_power_np if self._sk_np is not None \
            else self._sk_power
        return RelinKeys(keys={p: self._generate_one_kswitch_key(power(p))
                               for p in range(2, count + 2)})

    @profiling.spanned("keygen")
    def create_galois_keys(self, steps: Optional[Sequence[int]] = None,
                           elts: Optional[Sequence[int]] = None
                           ) -> GaloisKeys:
        """Keys switching s(x^elt) -> s for each Galois element: ``elts``,
        or the elements of rotation ``steps`` (0 = the row swap), or by
        default every power-of-two step both ways and the row swap
        (keygenerator.cpp:162; galois.cpp:125-150). The rotated secret is
        a permutation of the NTT-form key words (on the device, kernel M,
        for an external key).

        Each key from a generated secret is one switching key made on the
        host: with the native runtime about 0.2 s at n = 16384 and 3 s at
        32768 on an H100 machine's host (PERF.md); without it, through the
        pure-Python BLAKE2Xb, about 10 s at n = 16384, so the default set
        (2 log2(n) - 1 keys, 27 at n = 16384) takes minutes."""
        n = self.context.n
        if elts is None:
            elts = (galois_util.get_elts_all(n) if steps is None
                    else galois_util.get_elts_from_steps(n, steps))
        keys = {}
        for elt in elts:
            if self._sk_np is not None:
                perm = galois_util.ntt_permutation(n, elt)
                rotated = np.take(self._sk_np, perm, axis=-1)
            else:
                rotated = dgalois.permute(self._secret_key.data,
                                          dgalois.ntt_table(
                                              n, elt, self.context.device))
            keys[int(elt)] = self._generate_one_kswitch_key(rotated)
        return GaloisKeys(keys=keys)

    @profiling.spanned("keygen")
    def create_automorphism_keys(self) -> GaloisKeys:
        """Galois keys for every element 2^i + 1, the set the LWE packing
        and field trace use (keygenerator_cuda.cuh:288)."""
        log_n = self.context.n.bit_length() - 1
        return self.create_galois_keys(
            elts=[(1 << i) + 1 for i in range(1, log_n + 1)])

    @profiling.spanned("keygen")
    def create_keyswitch_key(self, old_sk: SecretKey) -> KSwitchKeys:
        """The key switching old_sk's ciphertexts to this generator's key,
        as keys[1] (keygenerator.h createKeySwitchingKey); made on the
        device from the key's words."""
        return KSwitchKeys(keys={1: self._generate_one_kswitch_key(
            old_sk.data)})
