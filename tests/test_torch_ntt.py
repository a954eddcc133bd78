"""troy_tpu_torch.ops.ntt against troy_tpu.ops.ntt, word for word.

At n = 4096 the JAX package takes its MXU 4-step path, whose outputs are
reduced even when lazy; so the port's lazy outputs are compared after
reduction mod q, and its reduced outputs directly. Runs on the CPU, where
the port's wrappers run the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from troy_tpu.ops import ntt as jntt
from troy_tpu.modulus import CoeffModulus as JCoeffModulus

from troy_tpu_torch.interop import to_numpy, to_torch
from troy_tpu_torch.ops import ntt as tntt
from troy_tpu_torch.ops import u64ops as tu

torch.set_num_threads(1)

BITS = {1: [50], 6: [60, 40, 40, 40, 40, 60]}


def _moduli(n, k):
    return tuple(int(m) for m in JCoeffModulus.create(n, BITS[k]))


def _uniform(rng, moduli, lead, n, mult=1):
    cols = [rng.integers(0, mult * q, size=lead + (1, n), dtype=np.uint64)
            for q in moduli]
    return np.concatenate(cols, axis=-2)


@pytest.fixture(scope="module", params=[(64, 1), (64, 6), (1024, 1),
                                        (1024, 6), (4096, 1), (4096, 6)],
                ids=lambda p: f"n{p[0]}-k{p[1]}")
def bases(request):
    n, k = request.param
    moduli = _moduli(n, k)
    return (n, moduli, jntt.RnsNttTables.from_moduli(n, moduli),
            tntt.RnsNttTables.from_moduli(n, moduli, "cpu"))


def _reduce(x, t):
    return tu.reduce_4q(x, t.q.reshape(-1, 1))


def test_rns_forward_and_inverse(bases):
    n, moduli, jt, tt = bases
    rng = np.random.default_rng(n + len(moduli))
    x = _uniform(rng, moduli, (2,), n)
    fwd = jntt.rns_ntt_forward(jnp.asarray(x), jt)
    got = tntt.rns_ntt_forward(to_torch(x), tt)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(fwd))
    lazy = tntt.rns_ntt_forward(to_torch(x), tt, lazy=True)
    np.testing.assert_array_equal(to_numpy(_reduce(lazy, tt)), np.asarray(fwd))
    # inverse of a lazy (< 2q) input
    y = _uniform(rng, moduli, (2,), n, mult=2)
    inv = jntt.rns_ntt_inverse(jnp.asarray(y), jt)
    np.testing.assert_array_equal(
        to_numpy(tntt.rns_ntt_inverse(to_torch(y), tt)), np.asarray(inv))
    lazy = tntt.rns_ntt_inverse(to_torch(y), tt, lazy=True)
    np.testing.assert_array_equal(to_numpy(_reduce(lazy, tt)), np.asarray(inv))
    # round trip
    back = tntt.rns_ntt_inverse(got, tt)
    np.testing.assert_array_equal(to_numpy(back), x)


def test_single_modulus_and_limb_transforms(bases):
    n, moduli, jt, tt = bases
    rng = np.random.default_rng(7 * n)
    i = len(moduli) - 1
    x = rng.integers(0, moduli[i], size=(3, n), dtype=np.uint64)
    want = jntt.ntt_forward_limb(jnp.asarray(x), jt, i)
    np.testing.assert_array_equal(
        to_numpy(tntt.ntt_forward_limb(to_torch(x), tt, i)), np.asarray(want))
    want = jntt.ntt_inverse_limb(jnp.asarray(x), jt, i)
    np.testing.assert_array_equal(
        to_numpy(tntt.ntt_inverse_limb(to_torch(x), tt, i)), np.asarray(want))


def test_rns_dyadic_mul(bases):
    n, moduli, jt, tt = bases
    rng = np.random.default_rng(11 * n)
    a = _uniform(rng, moduli, (2,), n)
    b = _uniform(rng, moduli, (2,), n)
    want = jntt.rns_dyadic_mul(jnp.asarray(a), jnp.asarray(b), jt)
    got = tntt.rns_dyadic_mul(to_torch(a), to_torch(b), tt)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    # lazy (< 4q) operands reduce to the same words
    a4 = a + np.uint64(2) * np.array(moduli, dtype=np.uint64)[:, None]
    got = tntt.rns_dyadic_mul(to_torch(a4), to_torch(b), tt)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_dyadic_mac_sums_terms_and_broadcasts(bases):
    """J terms summed in 128 bits equal the sum of single products, and a
    (J, k, n) operand broadcasts over b's extra leading axis."""
    n, moduli, jt, tt = bases
    rng = np.random.default_rng(13 * n)
    a = _uniform(rng, moduli, (3,), n)
    b = _uniform(rng, moduli, (3, 2), n)
    got = tntt.dyadic_mac(to_torch(a), to_torch(b), tt)
    for c in range(2):
        acc = None
        for j in range(3):
            p = jntt.rns_dyadic_mul(jnp.asarray(a[j]), jnp.asarray(b[j, c]),
                                    jt)
            acc = p if acc is None else jntt.u.add_mod(
                acc, p, jt.q.reshape(-1, 1))
        np.testing.assert_array_equal(to_numpy(got[c]), np.asarray(acc))


def test_select_and_slice_tables(bases):
    n, moduli, jt, tt = bases
    idx = [len(moduli) - 1, 0]
    js, ts = jt.select(idx), tt.select(idx)
    assert ts.values == js.values
    np.testing.assert_array_equal(to_numpy(ts.root_powers),
                                  np.asarray(js.root_powers))
    assert tt.select(idx) is ts
    sl = tt.slice(0, 1)
    np.testing.assert_array_equal(to_numpy(sl.q), np.asarray(jt.slice(0, 1).q))
