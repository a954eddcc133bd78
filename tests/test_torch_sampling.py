"""Kernel I's plain versions (troy_tpu_torch/ops/sampling.py) against
troy_tpu's device samplers, on the CPU.

The threefry twin against ``jax.random.bits(PRNGKey(seed), shape,
uint64)`` for seeds 0, 1, 2^63 + 5 and 2^64 - 1 and the shapes (n,) and
(2, k, n); the uniform, CBD (also times t, as BGV scales its noise) and
ternary samplers and the centred lift against troy_tpu.rlwe's
``sample_uniform_rns_dev``, ``sample_cbd_dev``, ``sample_ternary_dev`` and
``_lift_centered_i64`` at n = 4096, q = {60,40,40,40,60}, at the key level
(5 limbs) and the first data level (4 limbs), for one seed and for a batch
of seeds (troy_tpu's vmapped draws). Tolerance 0: the samples are words.
The layout holds for JAX's default ``jax_threefry_partitionable``, which
the first test asserts, so that a JAX with the other default fails here
rather than in a mismatch further on.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import troy_tpu as J
from troy_tpu import rlwe as jrlwe
from troy_tpu.ops import poly as jpoly

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch.ops import sampling

torch.set_num_threads(2)

SEEDS = [0, 1, 2 ** 63 + 5, 2 ** 64 - 1]
SHAPES = {"n": (4096,), "2kn": (2, 5, 1024)}
N = 4096
BITS = [60, 40, 40, 40, 60]
T_BITS = 20


def _np(x):
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _key(seed):
    return jrlwe._key_from_seed(jnp.uint64(seed))


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable, (
        "the threefry layout of troy_tpu_torch is JAX's partitionable one")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed, shape):
    shape = SHAPES[shape]
    want = np.asarray(jax.random.bits(_key(seed), shape, jnp.uint64))
    got = sampling.random_bits_plain(seed, int(np.prod(shape)), "cpu")
    np.testing.assert_array_equal(_np(got).reshape(shape), want)


def test_random_bits_batched_match_jax_vmap():
    seeds = np.array(SEEDS, dtype=np.uint64)
    want = np.asarray(jax.vmap(
        lambda s: jax.random.bits(jrlwe._key_from_seed(s), (2048,),
                                  jnp.uint64))(jnp.asarray(seeds)))
    got = sampling.random_bits_plain(interop.to_torch(seeds, "cpu"), 2048,
                                     "cpu")
    np.testing.assert_array_equal(_np(got), want)


@pytest.fixture(scope="module")
def levels():
    """(troy_tpu's context data, the port's tables) of the key level and
    the first data level, BGV so that t is defined."""
    out = {}
    ctxs = {}
    for mod in (J, P):
        parms = mod.EncryptionParameters(
            scheme=mod.SchemeType.bgv, poly_modulus_degree=N,
            coeff_modulus=tuple(mod.CoeffModulus.create(N, BITS)),
            plain_modulus=mod.PlainModulus.batching(N, T_BITS))
        on_cpu = {"device": "cpu"} if mod is P else {}
        ctxs[mod] = mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                  **on_cpu)
    for name in ("key", "first"):
        jcd, pcd = (getattr(ctxs[m], f"{name}_context_data") for m in (J, P))
        out[name] = (jcd, pcd.ntt, int(pcd.plain_modulus))
    return out


def _jax_sample(kind, key, cd, t):
    if kind == "uniform":
        return jrlwe.sample_uniform_rns_dev(key, cd)
    if kind == "ternary":
        return jrlwe._lift_centered_i64(jrlwe.sample_ternary_dev(key, cd.n),
                                        cd)
    e = jrlwe._lift_centered_i64(jrlwe.sample_cbd_dev(key, cd.n), cd)
    return jpoly.rns_broadcast_scalar_mul(e, t, cd.ntt) if kind == "cbd_t" \
        else e


def _port_sample(kind, seeds, tables, t):
    if kind == "uniform":
        return sampling.sample_uniform_rns(seeds, tables)
    if kind == "ternary":
        return sampling.sample_ternary_rns(seeds, tables)
    return sampling.sample_cbd_rns(seeds, tables,
                                   t if kind == "cbd_t" else None)


KINDS = ("uniform", "cbd", "cbd_t", "ternary")


@pytest.mark.parametrize("seed", [1, 2 ** 64 - 1])
@pytest.mark.parametrize("level", ["key", "first"])
@pytest.mark.parametrize("kind", KINDS)
def test_sampler_matches_jax(levels, kind, level, seed):
    cd, tables, t = levels[level]
    want = np.asarray(_jax_sample(kind, _key(seed), cd, t))
    got = _port_sample(kind, seed, tables, t)
    assert got.shape == (tables.k, N)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("kind", KINDS)
def test_batched_sampler_matches_jax_vmap(levels, kind):
    """A device array of seeds gives troy_tpu's vmapped draws, which are
    the single draws stacked."""
    cd, tables, t = levels["key"]
    seeds = np.array([3, 2 ** 63 + 5, 11], dtype=np.uint64)
    want = np.asarray(jax.vmap(
        lambda s: _jax_sample(kind, jrlwe._key_from_seed(s), cd, t))(
            jnp.asarray(seeds)))
    got = _port_sample(kind, interop.to_torch(seeds, "cpu"), tables, t)
    np.testing.assert_array_equal(_np(got), want)
    for i, s in enumerate(seeds):
        np.testing.assert_array_equal(
            _np(_port_sample(kind, int(s), tables, t)), want[i])


def test_lift_centered_matches_jax(levels):
    cd, tables, _ = levels["first"]
    e = np.random.default_rng(3).integers(-40, 41, N)
    want = np.asarray(jrlwe._lift_centered_i64(jnp.asarray(e), cd))
    got = sampling.lift_centered_plain(torch.from_numpy(e), tables)
    np.testing.assert_array_equal(_np(got), want)


def test_sampler_values():
    """The ranges the samplers promise, on many words: CBD within +-21,
    ternary in {-1, 0, 1} with every value drawn, and the ternary's mod 3
    of the full unsigned word (the high half matters)."""
    bits = sampling.random_bits_plain(7, 1 << 14, "cpu")
    cbd = sampling.cbd_plain(bits)
    assert int(cbd.abs().max()) <= 21
    tern = sampling.ternary_plain(bits)
    assert set(tern.unique().tolist()) == {-1, 0, 1}
    words = interop.to_numpy(bits).astype(object)
    np.testing.assert_array_equal(
        tern.numpy(), np.array([int(w) % 3 - 1 for w in words]))


@pytest.mark.parametrize("seed", [-1, 1 << 64])
def test_seed_out_of_range_raises(levels, seed):
    _, tables, _ = levels["first"]
    for sample in (sampling.sample_uniform_rns, sampling.sample_cbd_rns,
                   sampling.sample_ternary_rns):
        with pytest.raises(ValueError, match="u64"):
            sample(seed, tables)
