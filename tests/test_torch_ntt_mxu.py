"""Kernel J's tables and plain version against troy_tpu.ops.ntt_mxu.

The port's 4-step int8 transform (troy_tpu_torch/ops/ntt_mxu.py) must make
troy_tpu's tables (biased digit planes, plane sums, twiddles and Shoup
words) and, run as its plain version on the CPU, give troy_tpu's words:
forward and inverse at n = 2048 and 4096 with primes of 30, 40, 55 and 60
bits, with an X-plane bound, and on one limb at n = 32768 and 65536
(A = B = 256 at 65536, the contraction length of tests/test_ntt_mxu.py's
wide-factor case). Through ops/ntt.py, tables made with ``use_mxu`` give
A's words (with lazy off; J is always reduced).

Kernel J computes each stage with butterflies on its own tables (the
A-point table of psi^B, the cyclic B-point table of psi^A, the inverse
grid over B, 1/A): the tables are held to Python integers, and a plain
PyTorch emulation of the kernel's butterfly stages that reads them is held
word for word to the plain version's matrix stages, whole and on the
shard tables.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from troy_tpu.ops import ntt_mxu as jmxu

from troy_tpu_torch import CoeffModulus
from troy_tpu_torch.interop import to_numpy, to_torch
from troy_tpu_torch.ops import ntt, ntt_mxu
from troy_tpu_torch.ops import u64ops as u
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
    """use_mxu=None: A up to MAX_KERNEL_N = 131072 (the crossover measured
    on the H100), J above; True needs n >= 2048."""
    assert ntt.MAX_KERNEL_N == 131072
    small = [int(m) for m in CoeffModulus.create(4096, [40])]
    assert ntt.RnsNttTables.from_moduli(4096, small, "cpu").mxu is None
    assert ntt.RnsNttTables.from_moduli(4096, small, "cpu",
                                        use_mxu=True).mxu is not None
    mid = [int(m) for m in CoeffModulus.create(32768, [40])]
    assert ntt.RnsNttTables.from_moduli(32768, mid, "cpu").mxu is None
    assert ntt.RnsNttTables.from_moduli(32768, mid, "cpu",
                                        use_mxu=True).mxu is not None
    big = [int(m) for m in CoeffModulus.create(262144, [40])]
    assert ntt.RnsNttTables.from_moduli(262144, big, "cpu").mxu is not None
    assert ntt.RnsNttTables.from_moduli(262144, big, "cpu",
                                        use_mxu=False).mxu is None
    tiny = [int(m) for m in CoeffModulus.create(1024, [40])]
    with pytest.raises(ValueError, match="J takes"):
        ntt.RnsNttTables.from_moduli(1024, tiny, "cpu", use_mxu=True)
    assert ntt_mxu.MXU_MIN_N == 2048


# --------------------------------------------------------------------------
# kernel J's butterfly tables and stages
# --------------------------------------------------------------------------

def _ints(x):
    return [int(v) for v in to_numpy(x).reshape(-1)]


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("bits", [30, 40, 55, 60])
def test_butterfly_tables(n, bits):
    """The butterfly fields against Python integers made from the psi of
    make_mxu_tables_host's twiddle grid (Tw[0, 1] = psi)."""
    q, _, pt = _pair(n, bits)
    A, B, w1, tw, w2, v1, itw, v2 = ntt_mxu.make_mxu_tables_host(n, q)
    psi = int(tw[0][1])
    assert pow(psi, n, q) == q - 1 and int(w1[0][1]) == pow(psi, B, q)
    root_a, root_b = pow(psi, B, q), pow(psi, A, q)
    la, lb = A.bit_length() - 1, B.bit_length() - 1
    want_a = [pow(root_a, numth.reverse_bits(j, la), q) for j in range(A)]
    want_b = [1] + [pow(root_b, numth.reverse_bits(j - (1 << r), lb), q)
                    for j in range(1, B) for r in [j.bit_length() - 1]]
    inv = lambda t: [pow(x, q - 2, q) for x in t]
    shoup = lambda t: [(x << 64) // q for x in t]
    for name, want in (("a_roots", want_a), ("a_inv_roots", inv(want_a)),
                       ("b_roots", want_b), ("b_inv_roots", inv(want_b))):
        assert _ints(getattr(pt, name)) == want, name
        assert _ints(getattr(pt, name + "_shoup")) == shoup(want), name
    inv_b = pow(B, q - 2, q)
    want_itw = [int(x) * inv_b % q for row in itw for x in row]
    assert pt.itw_b.shape == (A, B)
    assert _ints(pt.itw_b) == want_itw
    assert _ints(pt.itw_b_shoup) == shoup(want_itw)
    inv_a = pow(A, q - 2, q)
    assert _ints(pt.consts)[13:15] == [inv_a, (inv_a << 64) // q]


def _butterflies(v, roots, shoup, q, inverse):
    """The kernel's rounds on lines along the last axis: Harvey's lazy
    forward butterflies (words in [0, 4q)) or Gentleman-Sande's inverse
    ones ([0, 2q)), round r's block b taking entry 2^r + b of the one
    table every line shares."""
    L = v.shape[-1]
    lead = v.shape[:-1]
    q2 = 2 * q
    log_l = L.bit_length() - 1
    for r in (range(log_l - 1, -1, -1) if inverse else range(log_l)):
        m, gap = 1 << r, L >> (r + 1)
        w = roots[m:2 * m].reshape(m, 1)
        wq = shoup[m:2 * m].reshape(m, 1)
        v = v.reshape(lead + (m, 2, gap))
        a, b = v[..., 0, :], v[..., 1, :]
        if inverse:
            s = a + b
            pair = [torch.where(s >= q2, s - q2, s),
                    u.mul_mod_shoup_lazy(a - b + q2, w, wq, q)]
        else:
            a = torch.where(a >= q2, a - q2, a)
            bw = u.mul_mod_shoup_lazy(b, w, wq, q)
            pair = [a + bw, a - bw + q2]
        v = torch.stack(pair, dim=-2).reshape(lead + (L,))
    return v


def _emulated_stage(x, t, stage):
    """Kernel J's stage on one limb's blocks x (..., R, C), from the
    tables' butterfly fields: reduce every word, run the length-A (left)
    or cyclic length-B (right) rounds, then the epilogue (Tw, iTw / B,
    1/A or the final reduction)."""
    q = t.modulus
    left, inverse = stage.endswith("left"), stage.startswith("inverse")
    v = u.barrett_reduce_64(x, q, ((1 << 128) // q) >> 64)
    if left:
        v = v.transpose(-1, -2)
    name = ("a_" if left else "b_") + ("inv_roots" if inverse else "roots")
    v = _butterflies(v, getattr(t, name), getattr(t, name + "_shoup"), q,
                     inverse)
    if left:
        v = v.transpose(-1, -2)
    if stage == "forward_left":
        return u.mul_mod_shoup(v, t.tw, t.tw_shoup, q)
    if stage == "forward_right":
        return u.reduce_4q(v, q)
    if stage == "inverse_right":
        return u.mul_mod_shoup(v, t.itw_b, t.itw_b_shoup, q)
    consts = _ints(t.consts)
    return u.mul_mod_shoup(v, consts[13], consts[14], q)


def _stage_inputs(rng, q, shape):
    """Any u64 words for the stages that reduce their input, words below q
    for the others (the plain version's planes cover only those)."""
    return {"forward_left": rng.integers(0, 2 ** 64, shape, dtype=np.uint64),
            "forward_right": rng.integers(0, q, shape, dtype=np.uint64),
            "inverse_right": rng.integers(0, 2 ** 64, shape,
                                          dtype=np.uint64),
            "inverse_left": rng.integers(0, q, shape, dtype=np.uint64)}


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("bits", [30, 40, 55, 60])
def test_butterfly_stages_are_the_matrix_stages(n, bits):
    q, _, pt = _pair(n, bits)
    rng = np.random.default_rng(n * bits)
    for stage, x in _stage_inputs(rng, q, (3, pt.a, pt.b)).items():
        xt = to_torch(x, "cpu")
        want = ntt_mxu.mxu_stage_plain(xt.unsqueeze(-3), (pt,), stage)
        got = _emulated_stage(xt, pt, stage)
        assert torch.equal(got, want.squeeze(-3)), stage
    # and the whole transforms, stage after stage
    x = to_torch(rng.integers(0, 2 ** 64, (2, n), dtype=np.uint64), "cpu")
    y = x.reshape(2, pt.a, pt.b)
    for stage in ntt_mxu.FORWARD:
        y = _emulated_stage(y, pt, stage)
    assert torch.equal(y.reshape(2, n),
                       ntt_mxu.ntt_forward_mxu_plain(x, pt))
    for stage in ntt_mxu.INVERSE:
        y = _emulated_stage(y, pt, stage)
    assert torch.equal(y.reshape(2, n),
                       u.barrett_reduce_64(x, q, ((1 << 128) // q) >> 64))


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("parts", [2, 4])
def test_butterfly_stages_on_shard_tables(n, parts):
    """Every rank's stages on its blocks: column blocks (A, B / parts) for
    the left stages, row blocks (A / parts, B) for the right."""
    q = numth.get_prime(2 * n, 55)
    rng = np.random.default_rng(n + parts)
    for i in range(parts):
        t = ntt_mxu.make_shard_tables(n, q, "cpu", parts, i)
        assert t.itw_b.shape == (t.a // parts, t.b)
        for stage in ntt_mxu.STAGES:
            shape = (2, t.a, t.b // parts) if stage.endswith("left") \
                else (2, t.a // parts, t.b)
            x = to_torch(_stage_inputs(rng, q, shape)[stage], "cpu")
            want = ntt_mxu.mxu_stage_plain(x.unsqueeze(-3), (t,), stage)
            assert torch.equal(_emulated_stage(x, t, stage),
                               want.squeeze(-3)), (stage, i)
