"""The host PRNG streams and samplers of troy_tpu_torch, on the CPU.

The twin of what tests/test_prng.py pins that tests/test_torch_host_layer.py
does not (that file holds the port's streams and samplers to troy_tpu's):
the BLAKE2Xb and SHAKE-256 outputs of troy's own randomgen (blake2b.c,
blake2xb.c, fips202.c), troy's ternary, CBD and uniform samplers seeded
through its compiled library (tests/data/ref_samplers.txt; generator kept
beside it), the seed size, the stream's statefulness across the 4 KiB
refills, the factory, and the samplers' ranges. test_prng.py's device
sampler case belongs to kernel I (the threefry draws of the default
encryption path): tests/test_torch_zero_fused.py and
tests/test_torch_sampling.py hold those. No JAX.
"""

import pathlib

import numpy as np
import pytest
import torch

import troy_tpu_torch as P
from troy_tpu_torch import prng as rnd

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).resolve().parent / "data" / "ref_samplers.txt"


def test_seed_size_enforced():
    with pytest.raises(ValueError):
        rnd.UniformRandomGenerator(b"short")


def test_same_seed_same_stream():
    s = rnd.seed_from_uint64(1, 2, 3)
    g1 = rnd.UniformRandomGenerator(s)
    g2 = rnd.UniformRandomGenerator(s)
    assert g1.generate(10000) == g2.generate(10000)


def test_stream_is_stateful_and_block_aligned():
    """Reading 100 bytes then 100 more equals reading 200 at once: the
    buffered refill is transparent (randomgen.h:309-388)."""
    s = rnd.seed_from_uint64(99)
    g1 = rnd.UniformRandomGenerator(s)
    g2 = rnd.UniformRandomGenerator(s)
    a = g1.generate(100) + g1.generate(100) + g1.generate(5000)
    b = g2.generate(5200)
    assert a == b


def test_blake2xb_and_shake256_differ():
    s = rnd.seed_from_uint64(7)
    g1 = rnd.UniformRandomGenerator(s, rnd.PrngType.blake2xb)
    g2 = rnd.UniformRandomGenerator(s, rnd.PrngType.shake256)
    assert g1.generate(64) != g2.generate(64)


def test_factory_default_seed_reproducible():
    f = rnd.RandomGeneratorFactory(default_seed=rnd.seed_from_uint64(5))
    assert not f.use_random_seed()
    assert f.create().generate(256) == f.create().generate(256)
    f2 = rnd.RandomGeneratorFactory()
    assert f2.use_random_seed()
    assert f2.create().generate(256) != f2.create().generate(256)


def test_ternary_sampler_range_and_balance():
    g = rnd.UniformRandomGenerator(rnd.seed_from_uint64(11))
    v = rnd.sample_poly_ternary(g, 4096)
    assert set(np.unique(v)) <= {-1, 0, 1}
    # each value about a third of the draws
    for x in (-1, 0, 1):
        assert 0.25 < np.mean(v == x) < 0.42


def test_cbd_sampler_sigma():
    g = rnd.UniformRandomGenerator(rnd.seed_from_uint64(12))
    v = rnd.sample_poly_cbd(g, 1 << 14)
    # Var = 2 * 21 / 4 = 10.5 -> sigma ~= 3.24 (globals.h:31 sigma 3.2)
    assert abs(v.mean()) < 0.2
    assert 3.0 < v.std() < 3.5


def test_uniform_sampler_in_range():
    g = rnd.UniformRandomGenerator(rnd.seed_from_uint64(13))
    moduli = [(1 << 30) - 35, (1 << 40) - 87]
    out = rnd.sample_poly_uniform(g, 2048, moduli)
    assert out.shape == (2, 2048)
    for i, q in enumerate(moduli):
        assert out[i].max() < q
        # roughly uniform: mean near q/2
        assert 0.4 * q < out[i].mean() < 0.6 * q


def test_blake2xb_matches_reference_implementation():
    """Byte-exact vectors from troy's blake2b.c/blake2xb.c called as
    blake2xb(out, 4096, &counter, 8, seed, 64) with seed word0 = 42, the
    refill of Blake2xbPRNG (randomgen.cpp:188-198)."""
    s = rnd.seed_from_uint64(42)
    g = rnd.UniformRandomGenerator(s, rnd.PrngType.blake2xb)
    b0 = g.generate(4096)
    b1 = g.generate(4096)
    assert b0[:32].hex() == ("f9cf417748e5fa9bdfddcffc71cfb91a"
                             "b29f75191b05971456afd7d916e0be6d")
    assert b1[:32].hex() == ("322ed3f66c3dbba67ee886e0298f3be3"
                             "76da8ee106ed6c85691a719bce288d11")


def test_shake256_matches_reference_implementation():
    """troy's fips202.c shake256 of seed (64 bytes, word0 = 42) || counter
    (8 bytes little-endian, 0): the Shake256PRNG refill
    (randomgen.cpp:200-211)."""
    s = rnd.seed_from_uint64(42)
    g = rnd.UniformRandomGenerator(s, rnd.PrngType.shake256)
    assert g.generate(4096)[:32].hex() == (
        "f546dabdf1796fa91dfba252e59c8859"
        "fe614d0bd39a377b322cd6f6a80816e1")


def test_samplers_match_reference_draw_order():
    """troy's own host samplers (rlwe.cpp samplePolyTernary/Cbd/Uniform,
    seeded through its compiled library): the ternary and CBD vectors
    share one stream, as KeyGenerator and Encryptor draw them."""
    vecs = {}
    for line in DATA.read_text().splitlines():
        parts = line.split()
        vecs[parts[0]] = np.array(parts[2:2 + int(parts[1])],
                                  dtype=np.uint64)
    mods = [int(m) for m in P.CoeffModulus.create(64, [40, 40, 40])]
    n, k = 64, 3

    g = rnd.UniformRandomGenerator(rnd.seed_from_uint64(42))
    ternary = rnd.sample_poly_ternary(g, n)
    np.testing.assert_array_equal(rnd.centered_to_rns(ternary, mods),
                                  vecs["ternary"].reshape(k, n))
    cbd = rnd.sample_poly_cbd(g, n)          # continues the same stream
    np.testing.assert_array_equal(rnd.centered_to_rns(cbd, mods),
                                  vecs["cbd"].reshape(k, n))

    g2 = rnd.UniformRandomGenerator(rnd.seed_from_uint64(42))
    uniform = rnd.sample_poly_uniform(g2, n, mods)
    np.testing.assert_array_equal(uniform, vecs["uniform"].reshape(k, n))
