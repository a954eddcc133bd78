"""Key generation: the secret key, relinearization and Galois keys on the host.

The port of troy_tpu/keygen.py, host path only: like the reference
(keygenerator_cuda.cuh:51-85 wraps a host key generator), every key is
computed in numpy (utils/host_ntt twins the transforms word for word) and
uploaded once, as one finished tensor, to the context's device.

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

from .context import HeContext
from .he_types import GaloisKeys, RelinKeys, SecretKey
from .interop import to_torch
from . import prng as rnd
from . import rlwe
from .utils import galois as galois_util
from .utils import host_ntt as hntt
from .utils.ntt_tables import make_ntt_tables


class KeyGenerator:
    """(keygenerator.h:27)

    ``host_sampling=True`` makes every switching-key row consume a fresh
    replay of the seed stream, as the reference's seeded factory does
    (randomgen.h:419-427, keygenerator.cpp:294-338), so seeded relin keys
    are word-equal to the reference's. Otherwise the rows draw one after
    another from a single stream."""

    def __init__(self, context: HeContext, seed: Optional[bytes] = None,
                 host_sampling: bool = False):
        self.context = context
        if seed is None and host_sampling:
            seed = secrets.token_bytes(rnd.PRNG_SEED_BYTES)
        self._seed = seed
        self._host_sampling = host_sampling
        self._prng = rnd.RandomGeneratorFactory.default_factory().create(seed)
        self._sk_np = self._generate_sk_np()
        self._secret_key = SecretKey(data=to_torch(self._sk_np,
                                                   context.device))
        # NTT-domain powers of s over the key base: powers[p] = s^p
        self._sk_powers_np: Dict[int, np.ndarray] = {1: self._sk_np}

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

    def _sk_power_np(self, p: int) -> np.ndarray:
        if p not in self._sk_powers_np:
            cd = self.context.key_context_data
            self._sk_powers_np[p] = hntt.rns_dyadic_mul_np(
                self._sk_power_np(p - 1), self._sk_np, cd.n, cd.coeff_values)
        return self._sk_powers_np[p]

    def _kswitch_key_host(self, w_ntt_np: np.ndarray) -> torch.Tensor:
        """decomp zero encryptions plus the P*w term on c0's limb j of row
        j, all in numpy, uploaded once (keygenerator.cpp:294-338)."""
        ctx = self.context
        if not ctx.using_keyswitching:
            raise ValueError("parameters do not support keyswitching "
                             "(need >= 2 coefficient moduli)")
        key_cd = ctx.key_context_data
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
        return to_torch(np.stack(rows), ctx.device)

    def create_relin_keys(self, count: int = 1) -> RelinKeys:
        """Keys switching s^p -> s for p = 2 .. count+1
        (keygenerator.cpp:122)."""
        if count < 1 or count > 14:  # SEAL_CIPHERTEXT_SIZE_MAX - 2
            raise ValueError("invalid count")
        return RelinKeys(keys={p: self._kswitch_key_host(self._sk_power_np(p))
                               for p in range(2, count + 2)})

    def create_galois_keys(self, steps: Optional[Sequence[int]] = None,
                           elts: Optional[Sequence[int]] = None
                           ) -> GaloisKeys:
        """Keys switching s(x^elt) -> s for each Galois element: ``elts``,
        or the elements of rotation ``steps`` (0 = the row swap), or by
        default every power-of-two step both ways and the row swap
        (keygenerator.cpp:162; galois.cpp:125-150). The rotated secret is
        a permutation of the NTT-form key words.

        Each key is one switching key made on the host; with this package's
        pure-Python host fallbacks the default set (2 log2(n) - 1 keys, 27 at
        n = 16384) takes minutes."""
        n = self.context.n
        if elts is None:
            elts = (galois_util.get_elts_all(n) if steps is None
                    else galois_util.get_elts_from_steps(n, steps))
        keys = {}
        for elt in elts:
            perm = galois_util.ntt_permutation(n, elt)
            keys[int(elt)] = self._kswitch_key_host(
                np.take(self._sk_np, perm, axis=-1))
        return GaloisKeys(keys=keys)
