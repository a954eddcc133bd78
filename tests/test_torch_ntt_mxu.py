"""Kernel J's tables and plain version against troy_tpu.ops.ntt_mxu.

The port's 4-step int8 transform (troy_tpu_torch/ops/ntt_mxu.py) must make
troy_tpu's tables (biased digit planes, plane sums, twiddles and Shoup
words) and, run as its plain version on the CPU, give troy_tpu's words:
forward and inverse at n = 2048 and 4096 with primes of 30, 40, 55 and 60
bits, with an X-plane bound, and on one limb at n = 32768 and 65536
(A = B = 256 at 65536, the contraction length of tests/test_ntt_mxu.py's
wide-factor case). Through ops/ntt.py, tables made with ``use_mxu`` give
A's words (with lazy off; J is always reduced).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from troy_tpu.ops import ntt_mxu as jmxu

from troy_tpu_torch import CoeffModulus
from troy_tpu_torch.interop import to_numpy, to_torch
from troy_tpu_torch.ops import ntt, ntt_mxu
from troy_tpu_torch.utils import numth

torch.set_num_threads(1)

FIELDS = ("w1_digits", "w1_sums", "w2_digits", "w2_sums", "tw", "tw_shoup",
          "iw1_digits", "iw1_sums", "iw2_digits", "iw2_sums", "itw",
          "itw_shoup")


def _np(x):
    return to_numpy(x) if x.dtype == torch.int64 else x.numpy()


def _pair(n, bits):
    q = numth.get_prime(2 * n, bits)
    return q, jmxu.make_mxu_tables(n, q), ntt_mxu.make_mxu_tables(n, q,
                                                                 "cpu")


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("bits", [30, 40, 55, 60])
def test_tables_are_troy_tpus(n, bits):
    q, jt, pt = _pair(n, bits)
    assert (pt.n, pt.a, pt.b, pt.modulus) == (jt.n, jt.a, jt.b, jt.modulus)
    assert pt.planes == jmxu._ndigits(q) == (bits + 7) // 8
    for name in FIELDS:
        want = np.asarray(getattr(jt, name))
        got = getattr(pt, name)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(_np(got).astype(want.dtype), want,
                                      err_msg=name)
    assert pt.w1_sums.dtype == torch.int32 and pt.w1_digits.dtype == \
        torch.int8
    np.testing.assert_array_equal(_np(pt.w2t_digits),
                                  np.asarray(jt.w2_digits).transpose(0, 2, 1))
    np.testing.assert_array_equal(_np(pt.iw2t_digits),
                                  np.asarray(jt.iw2_digits).transpose(0, 2, 1))
    consts = [int(v) for v in to_numpy(pt.consts)]
    assert consts[:3] == [q, ((1 << 128) // q) >> 64, pt.planes]
    assert consts[5:9] == [pow(2, 32 * g, q) for g in range(4)]


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("bits", [30, 40, 55, 60])
def test_transforms_are_troy_tpus(n, bits):
    q, jt, pt = _pair(n, bits)
    rng = np.random.default_rng(n + bits)
    x = rng.integers(0, 2 ** 64, (3, n), dtype=np.uint64)   # any words
    np.testing.assert_array_equal(
        to_numpy(ntt_mxu.ntt_forward_mxu_plain(to_torch(x, "cpu"), pt)),
        np.asarray(jmxu.ntt_forward_mxu(jnp.asarray(x), jt)))
    np.testing.assert_array_equal(
        to_numpy(ntt_mxu.ntt_inverse_mxu_plain(to_torch(x, "cpu"), pt)),
        np.asarray(jmxu.ntt_inverse_mxu(jnp.asarray(x), jt)))


@pytest.mark.parametrize("x_bits", [30, 40])
def test_x_planes_are_troy_tpus(x_bits):
    """Words below 2^x_bits into a 60-bit prime's transform: no entry
    reduction and ceil(x_bits / 8) X planes."""
    n = 4096
    q, jt, pt = _pair(n, 60)
    planes = (x_bits + 7) // 8
    rng = np.random.default_rng(x_bits)
    x = rng.integers(0, 2 ** x_bits, (2, n), dtype=np.uint64)
    got = to_numpy(ntt_mxu.ntt_forward_mxu_plain(to_torch(x, "cpu"), pt,
                                                 planes))
    np.testing.assert_array_equal(got, np.asarray(jmxu.ntt_forward_mxu(
        jnp.asarray(x), jt, x_planes=planes)))
    np.testing.assert_array_equal(got, to_numpy(
        ntt_mxu.ntt_forward_mxu_plain(to_torch(x, "cpu"), pt)))


@pytest.mark.parametrize("n", [32768, 65536])
def test_one_limb_at_large_n(n):
    q, jt, pt = _pair(n, 60)
    assert (pt.a, pt.b) == ((256, 128) if n == 32768 else (256, 256))
    rng = np.random.default_rng(n)
    x = rng.integers(0, q, (n,), dtype=np.uint64)
    fwd = ntt_mxu.ntt_forward_mxu_plain(to_torch(x, "cpu"), pt)
    np.testing.assert_array_equal(
        to_numpy(fwd), np.asarray(jmxu.ntt_forward_mxu(jnp.asarray(x), jt)))
    back = ntt_mxu.ntt_inverse_mxu_plain(fwd, pt)
    np.testing.assert_array_equal(to_numpy(back), x)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("lazy", [False, True])
def test_j_gives_as_words(n, lazy):
    """Tables with use_mxu run J (plain on the CPU); A's words with lazy
    off, and J's reduced words reduce A's lazy ones."""
    moduli = [int(m) for m in CoeffModulus.create(n, [60, 40, 40, 55, 60])]
    a = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    j = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=True)
    assert a.mxu is None and len(j.mxu) == len(moduli)
    rng = np.random.default_rng(n)
    x = to_torch(np.concatenate(
        [rng.integers(0, 4 * q, (2, 1, n), dtype=np.uint64) for q in moduli],
        axis=1), "cpu")
    qs = a.q.reshape(-1, 1)
    want = ntt.rns_ntt_forward(x, a, lazy)
    got = ntt.rns_ntt_forward(x, j, lazy)
    assert torch.equal(got, want % qs if lazy else want)
    y = x % qs
    want = ntt.rns_ntt_inverse(y, a, lazy)
    assert torch.equal(ntt.rns_ntt_inverse(y, j, lazy),
                       want % qs if lazy else want)
    # one limb, through the single-modulus forms and a sub-base
    assert torch.equal(ntt.ntt_forward_limb(y[:, 3], j, 3),
                       ntt.ntt_forward_limb(y[:, 3], a, 3))
    sub = j.select([4, 1])
    assert sub.mxu == (j.mxu[4], j.mxu[1])
    assert torch.equal(ntt.rns_ntt_inverse(y[:, [4, 1]], sub),
                       ntt.rns_ntt_inverse(y[:, [4, 1]], a.select([4, 1])))
    both = ntt.RnsNttTables.concat(j.slice(0, 2), j.slice(2, 5))
    assert both.mxu == j.mxu
    assert torch.equal(ntt.rns_ntt_forward(y, both), ntt.rns_ntt_forward(y,
                                                                         a))


def test_x_bound_bits_keeps_the_words():
    """rns_ntt_forward's bound: limbs at least as wide take the words with
    fewer planes, narrower ones reduce first; A ignores it."""
    n = 2048
    moduli = [int(m) for m in CoeffModulus.create(n, [60, 40, 30])]
    j = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=True)
    a = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    rng = np.random.default_rng(3)
    x = to_torch(rng.integers(0, 2 ** 40, (2, 3, n), dtype=np.uint64), "cpu")
    want = ntt.rns_ntt_forward(x % a.q.reshape(-1, 1), a)
    assert torch.equal(ntt.rns_ntt_forward(x, j, x_bound_bits=40), want)
    assert torch.equal(ntt.rns_ntt_forward(x, a, x_bound_bits=40),
                       ntt.rns_ntt_forward(x, a))
    assert torch.equal(ntt.rns_ntt_forward(x, j), want)


def test_routing():
    """use_mxu=None: A up to n = 16384, J above; True needs n >= 2048."""
    small = [int(m) for m in CoeffModulus.create(4096, [40])]
    assert ntt.RnsNttTables.from_moduli(4096, small, "cpu").mxu is None
    assert ntt.RnsNttTables.from_moduli(4096, small, "cpu",
                                        use_mxu=True).mxu is not None
    big = [int(m) for m in CoeffModulus.create(32768, [40])]
    assert ntt.RnsNttTables.from_moduli(32768, big, "cpu").mxu is not None
    assert ntt.RnsNttTables.from_moduli(32768, big, "cpu",
                                        use_mxu=False).mxu is None
    tiny = [int(m) for m in CoeffModulus.create(1024, [40])]
    with pytest.raises(ValueError, match="J takes"):
        ntt.RnsNttTables.from_moduli(1024, tiny, "cpu", use_mxu=True)
    assert ntt_mxu.MXU_MIN_N == 2048
