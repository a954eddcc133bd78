"""Seeded random op chains through troy_tpu and troy_tpu_torch, compared
after every op.

At n = 64 (SecurityLevel.none), BFV, CKKS and BGV: both packages start from
the same seeded host-sampling keys and encryptions, then take the same
random sequence of ops, each applicable to the chain's ciphertext where it
stands, the hoisted path, the shift and the packing among them (add, sub, negate, multiply and relinearize, square, rotations
through a key and through the NAF, ``apply_galois_many``,
``negacyclic_shift``, the mod switch or rescale, the plaintext ops, and
``extract_lwe_many`` then ``pack_lwe_ciphertexts``), and after each op the
ciphertext's words and metadata must agree. Two known faults of troy_tpu
are left out of the chains, as the port does not copy them: an NTT-form
BFV ciphertext through a key switch, and a coefficient-form BGV ciphertext
through a Galois key switch or the packing (troy_tpu's key switch picks
its output domain by scheme, troy_tpu/evaluator.py:302, :345-348): BFV
stays in coefficient form and BGV in NTT form outside the shift.
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng

import troy_tpu_torch as P
from troy_tpu_torch import prng as tprng

torch.set_num_threads(1)

N = 64
LENGTH = 10
SEEDS = [11, 12]
SCALE = 2.0 ** 30


class Side:
    """One package's half of a chain."""

    def __init__(self, mod, prng, scheme, seed):
        self.mod, self.scheme = mod, scheme
        kw = {} if scheme == "ckks" else {
            "plain_modulus": mod.PlainModulus.batching(N, 20)}
        parms = mod.EncryptionParameters(
            scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=N,
            coeff_modulus=tuple(mod.CoeffModulus.create(N, [40] * 3)), **kw)
        on_cpu = {"device": "cpu"} if mod is P else {}
        self.ctx = mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                 **on_cpu)
        kg = mod.KeyGenerator(self.ctx, seed=prng.seed_from_uint64(seed),
                              host_sampling=True)
        self.rlk = kg.create_relin_keys()
        gk = kg.create_galois_keys(steps=[1, 2, -1, 4, 0])
        ak = kg.create_automorphism_keys()
        self.gk = mod.GaloisKeys(keys={**gk.keys, **ak.keys})
        self.enc = mod.Encryptor(self.ctx, secret_key=kg.secret_key,
                                 seed=prng.seed_from_uint64(seed + 1),
                                 host_sampling=True)
        self.ev = mod.Evaluator(self.ctx)
        if scheme == "ckks":
            self.encoder = mod.CKKSEncoder(self.ctx)
        else:
            self.encoder = mod.BatchEncoder(self.ctx)

    def encode(self, values, level, scale):
        if self.scheme == "ckks":
            return self.encoder.encode(values, scale, level)
        return self.encoder.encode(values)

    def words(self, ct):
        data = np.asarray(ct.data) if self.mod is J else P.to_numpy(ct.data)
        return data, (ct.level, ct.is_ntt_form, ct.scale,
                      ct.correction_factor)


def _ops(side, ct, rng_vals):
    """{op: function of (side, ct) -> ct} applicable to ct."""
    sch = side.scheme
    last = ct.level >= side.ctx.last_level
    ops = {
        "add": lambda s, c: s.ev.add(c, c),
        "sub": lambda s, c: s.ev.sub(s.ev.add(c, c), c),
        "negate": lambda s, c: s.ev.negate(c),
        "rotate1": lambda s, c: _rotate(s, c, 1),
        "rotate3": lambda s, c: _rotate(s, c, 3),         # NAF: 4 - 1
        "galois_many": lambda s, c: s.ev.apply_galois_many(
            c, sorted(s.gk.keys)[:3], s.gk)[1],
        "shift": _shift,
        "multiply_plain": lambda s, c: _plain_op(s, c, rng_vals, "mul"),
        "add_plain": lambda s, c: _plain_op(s, c, rng_vals, "add"),
    }
    if not last:
        ops["multiply"] = _multiply
        ops["square"] = _square
        ops["mod_switch"] = (lambda s, c: s.ev.rescale_to_next(c)
                             if s.scheme == "ckks"
                             else s.ev.mod_switch_to_next(c))
    if sch != "bgv":
        ops["extract_pack"] = lambda s, c: s.ev.pack_lwe_ciphertexts(
            s.ev.extract_lwe_many(c, [0, 5, 9, 33]), s.gk)
    if sch == "ckks" and last:
        del ops["multiply_plain"]
    return ops


def _rotate(s, c, step):
    if s.scheme == "ckks":
        return s.ev.rotate_vector(c, step, s.gk)
    return s.ev.rotate_rows(c, step, s.gk)


def _shift(s, c):
    if not c.is_ntt_form:
        return s.ev.negacyclic_shift(c, N + 3)
    return s.ev.transform_to_ntt(s.ev.negacyclic_shift(
        s.ev.transform_from_ntt(c), N + 3))


def _multiply(s, c):
    out = s.ev.relinearize(s.ev.multiply(c, c), s.rlk)
    return s.ev.rescale_to_next(out) if s.scheme == "ckks" else out


def _square(s, c):
    out = s.ev.relinearize(s.ev.square(c), s.rlk)
    return s.ev.rescale_to_next(out) if s.scheme == "ckks" else out


def _plain_op(s, c, values, kind):
    if s.scheme == "ckks":
        plain = s.encode(values, c.level, c.scale if kind == "add" else SCALE)
        if kind == "add":
            return s.ev.add_plain(c, plain)
        return s.ev.rescale_to_next(s.ev.multiply_plain(c, plain))
    plain = s.encode(values, c.level, 1.0)
    return (s.ev.add_plain if kind == "add" else s.ev.multiply_plain)(c,
                                                                      plain)


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
@pytest.mark.parametrize("seed", SEEDS)
def test_chain(scheme, seed):
    rng = np.random.default_rng(seed)
    sides = [Side(J, jprng, scheme, seed), Side(P, tprng, scheme, seed)]
    if scheme == "ckks":
        values = rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
        plain_values = rng.uniform(-1, 1, N // 2)
    else:
        t = sides[0].encoder.plain_modulus
        values = rng.integers(0, t, N, dtype=np.uint64)
        plain_values = rng.integers(0, t, N, dtype=np.uint64)
    cts = [s.enc.encrypt_symmetric(s.encode(values, None, SCALE))
           for s in sides]
    # every chain takes the hoisted path, the shift and (but BGV) the
    # packing, in a random order among the random ops
    required = ["galois_many", "shift"] + (["extract_pack"]
                                           if scheme != "bgv" else [])
    slots = rng.choice(LENGTH, len(required), replace=False)
    forced = dict(zip(slots, rng.permutation(required)))
    done = []
    for i in range(LENGTH):
        ops = _ops(sides[1], cts[1], plain_values)
        name = forced.get(i) or sorted(ops)[rng.integers(len(ops))]
        cts = [ops[name](s, c) for s, c in zip(sides, cts)]
        done.append(name)
        (want, want_meta), (got, got_meta) = (s.words(c)
                                              for s, c in zip(sides, cts))
        assert got_meta == want_meta, f"after {done}"
        np.testing.assert_array_equal(got, want, err_msg=f"after {done}")
