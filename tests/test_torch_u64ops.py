"""troy_tpu_torch.ops.u64ops (int64 twin) against troy_tpu.ops.u64ops.

Random full-range u64 words, including words >= 2^63 and the carry and
shift edge cases, go through both; the results must be the same words
(tolerance 0: the values are integers).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from troy_tpu.ops import u64ops as ju

from troy_tpu_torch import interop
from troy_tpu_torch.interop import to_numpy
from troy_tpu_torch.ops import u64ops as tu

torch.set_num_threads(1)


def to_torch(words):
    """Words on the CPU, where the wrappers run the plain versions."""
    return interop.to_torch(words, "cpu")

M64 = (1 << 64) - 1
SIZE = 4096
EDGES = np.array([0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
                  (1 << 63) - 1, 1 << 63, (1 << 63) + 1, M64 - 1, M64,
                  0xFFFFFFFF00000000, 0x00000000FFFFFFFF,
                  0x8000000080000000], dtype=np.uint64)
# moduli below 2^61, as every modulus of the framework
MODULI = [0xFFFFFFFFFFC0001, (1 << 61) - 1, 0x7FFFFFFFE90001, 65537,
          (1 << 40) - 87]


def _words(seed, size=SIZE):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 64, size=size, dtype=np.uint64)
    edges = np.tile(EDGES, -(-size // len(EDGES)))[:size]
    return np.concatenate([w, edges, np.roll(edges, 3)])


def _residues(seed, q, bound_mult=1):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, bound_mult * q, size=SIZE, dtype=np.uint64)
    edge = np.array([0, 1, q - 1, bound_mult * q - 1], dtype=np.uint64)
    return np.concatenate([r, edge])


def _eq(port, jax_out):
    np.testing.assert_array_equal(to_numpy(port), np.asarray(jax_out))


@pytest.mark.parametrize("name", ["mulhi64", "mul128", "add_u128"])
def test_wide_products_and_sums(name):
    a, b = _words(1), _words(2)
    c, d = _words(3), _words(4)
    ta, tb, tc, td = (to_torch(x) for x in (a, b, c, d))
    ja, jb, jc, jd = (jnp.asarray(x) for x in (a, b, c, d))
    if name == "mulhi64":
        _eq(tu.mulhi64(ta, tb), ju.mulhi64(ja, jb))
    elif name == "mul128":
        lo, hi = tu.mul128(ta, tb)
        jlo, jhi = ju.mul128(ja, jb)
        _eq(lo, jlo)
        _eq(hi, jhi)
    else:
        lo, hi = tu.add_u128(ta, tb, tc, td)
        jlo, jhi = ju.add_u128(ja, jb, jc, jd)
        _eq(lo, jlo)
        _eq(hi, jhi)


def test_mulhi64_against_python_ints():
    a, b = _words(5), _words(6)
    got = tu.mulhi64(to_torch(a), to_torch(b))
    want = np.array([(int(x) * int(y)) >> 64 for x, y in zip(a, b)],
                    dtype=np.uint64)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("q", MODULI)
def test_barrett_reductions(q):
    x, z_lo, z_hi = _words(7), _words(8), _words(9)
    ratio = (1 << 128) // q
    cr = (ratio & M64, ratio >> 64, 0)
    _eq(tu.barrett_reduce_64(to_torch(x), q, cr[1]),
        ju.barrett_reduce_64(jnp.asarray(x), q, cr[1]))
    _eq(tu.barrett_reduce_128(to_torch(z_lo), to_torch(z_hi), q, cr[0], cr[1]),
        ju.barrett_reduce_128(jnp.asarray(z_lo), jnp.asarray(z_hi), q, cr))
    # the per-limb (tensor modulus) form
    qs = np.array([q, MODULI[0]], dtype=np.uint64).reshape(2, 1)
    crs = [(1 << 128) // int(v) for v in qs[:, 0]]
    lo_w = np.array([c & M64 for c in crs], dtype=np.uint64).reshape(2, 1)
    hi_w = np.array([c >> 64 for c in crs], dtype=np.uint64).reshape(2, 1)
    zl, zh = z_lo.reshape(1, -1), z_hi.reshape(1, -1)
    _eq(tu.barrett_reduce_128(to_torch(zl), to_torch(zh), to_torch(qs),
                              to_torch(lo_w), to_torch(hi_w)),
        ju.barrett_reduce_128_dyn(jnp.asarray(zl), jnp.asarray(zh),
                                  jnp.asarray(qs), jnp.asarray(lo_w),
                                  jnp.asarray(hi_w)))


@pytest.mark.parametrize("q", MODULI)
def test_shoup_and_mul_mod(q):
    x = _words(10)
    rng = np.random.default_rng(11)
    w = int(rng.integers(1, q))
    wq = ju.shoup_quotient(w, q)
    assert tu.shoup_quotient(w, q) == wq
    _eq(tu.mul_mod_shoup_lazy(to_torch(x), w, wq, q),
        ju.mul_mod_shoup_lazy(jnp.asarray(x), ju.u64(w), ju.u64(wq), q))
    _eq(tu.mul_mod_shoup(to_torch(x), w, wq, q),
        ju.mul_mod_shoup(jnp.asarray(x), ju.u64(w), ju.u64(wq), q))
    a, b = _residues(12, q), _residues(13, q)
    ratio = (1 << 128) // q
    cr = (ratio & M64, ratio >> 64, 0)
    _eq(tu.mul_mod(to_torch(a), to_torch(b), q, cr),
        ju.mul_mod(jnp.asarray(a), jnp.asarray(b), q, cr))


@pytest.mark.parametrize("q", MODULI)
def test_add_sub_neg_and_lazy_reductions(q):
    a, b = _residues(14, q), _residues(15, q)
    ta, tb, ja, jb = to_torch(a), to_torch(b), jnp.asarray(a), jnp.asarray(b)
    _eq(tu.add_mod(ta, tb, q), ju.add_mod(ja, jb, q))
    _eq(tu.sub_mod(ta, tb, q), ju.sub_mod(ja, jb, q))
    _eq(tu.neg_mod(ta, q), ju.neg_mod(ja, q))
    x2, x4 = _residues(16, q, 2), _residues(17, q, 4)
    _eq(tu.reduce_2q(to_torch(x2), q), ju.reduce_2q(jnp.asarray(x2), q))
    _eq(tu.reduce_4q(to_torch(x4), q), ju.reduce_4q(jnp.asarray(x4), q))


def test_unsigned_compare_and_logical_shift():
    a, b = _words(18), _words(19)
    ult = tu.ult(to_torch(a), to_torch(b)).numpy()
    np.testing.assert_array_equal(ult, a < b)
    for s in (1, 31, 32, 33, 63):
        np.testing.assert_array_equal(to_numpy(tu.shr(to_torch(a), s)),
                                      a >> np.uint64(s))
