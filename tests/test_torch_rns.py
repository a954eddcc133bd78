"""troy_tpu_torch.ops.rns, ops.keyswitch and ops.poly against troy_tpu.

The BEHZ conversions and their fused forms (kernel E), the BFV decrypt
rounding, the key switch's digit reduction and divide-and-round (kernels F
and K), the per-limb RNS ops and the BFV plain embedding (kernel G), on the
same seeded inputs, must give the same words (tolerance 0). Here on the
CPU each wrapper runs its kernel's plain version. The port's functions
take leading batch axes; the JAX functions take one polynomial, so batches
are compared row by row.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from troy_tpu.modulus import CoeffModulus as JCoeffModulus
from troy_tpu.ops import ntt as jntt
from troy_tpu.ops import poly as jpoly
from troy_tpu.ops import rns as jrns
from troy_tpu.ops import u64ops as ju
from troy_tpu.utils.rns import make_rns_tool as j_make_rns_tool

from troy_tpu_torch import interop
from troy_tpu_torch.interop import to_numpy
from troy_tpu_torch.ops import keyswitch as tks
from troy_tpu_torch.ops import ntt as tntt
from troy_tpu_torch.ops import poly as tpoly
from troy_tpu_torch.ops import rns as trns
from troy_tpu_torch.utils.rns import make_rns_tool as t_make_rns_tool

torch.set_num_threads(1)


def to_torch(words):
    """Words on the CPU, where the wrappers run the plain versions."""
    return interop.to_torch(words, "cpu")

CONFIGS = {
    "n64-k3-t17b": (64, [40, 40, 40], 65537),
    "n1024-k5-t20b": (1024, [60, 40, 40, 40, 40], None),
    "n4096-k3-t2^41": (4096, [36, 36, 37], 1 << 41),
    "n1024-k5-t786433": (1024, [60, 40, 40, 40, 40], 786433),
    "n64-k3-t6*65537": (64, [40, 40, 40], 6 * 65537),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def cfg(request):
    n, bits, t = CONFIGS[request.param]
    q = tuple(int(m) for m in JCoeffModulus.create(n, bits))
    if t is None:       # a 20-bit batching prime
        t = int(JCoeffModulus.create(n, [20])[0])
    jtool = j_make_rns_tool(n, q, t)
    ttool = t_make_rns_tool(n, q, t)
    tq = tntt.RnsNttTables.from_moduli(n, q, "cpu")
    tb = tntt.RnsNttTables.from_moduli(n, ttool.base_Bsk.values, "cpu")
    dev = trns.DeviceRnsTool.build(ttool, tq, tb)
    jq = jntt.RnsNttTables.from_moduli(n, q, use_mxu=False)
    return n, q, t, jtool, dev, tq, jq


def _res(rng, moduli, n, lead=()):
    return np.concatenate([rng.integers(0, m, size=lead + (1, n),
                                        dtype=np.uint64) for m in moduli],
                          axis=-2)


def _rows_eq(port, jax_fn, xs):
    """port: (B, ..., n) tensor; jax_fn applied to each row of xs."""
    got = to_numpy(port)
    for b in range(xs.shape[0]):
        np.testing.assert_array_equal(got[b], np.asarray(jax_fn(
            jnp.asarray(xs[b]))))


def test_fast_convert(cfg):
    n, q, t, jtool, dev, _, _ = cfg
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 64, size=(2, len(q), n), dtype=np.uint64)
    for jconv, tconv in ((jtool.conv_q_to_Bsk, dev.q_to_bsk),
                         (jtool.conv_q_to_t_gamma, dev.q_to_t_gamma)):
        _rows_eq(trns.fast_convert(to_torch(x), tconv),
                 lambda r: jrns.fast_convert(r, jconv), x)
    # the merged converters equal the JAX package's two conversions stacked
    mt = trns.fast_convert(to_torch(x), dev.q_to_bsk_m_tilde)
    _rows_eq(mt, lambda r: jnp.concatenate(
        [jrns.fast_convert(r, jtool.conv_q_to_Bsk),
         jrns.fast_convert(r, jtool.conv_q_to_m_tilde)]), x)
    nb = jtool.base_B.size
    xb = rng.integers(0, 1 << 64, size=(2, nb, n), dtype=np.uint64)
    _rows_eq(trns.fast_convert(to_torch(xb), dev.b_to_q_m_sk),
             lambda r: jnp.concatenate(
                 [jrns.fast_convert(r, jtool.conv_B_to_q),
                  jrns.fast_convert(r, jtool.conv_B_to_m_sk)]), xb)


def test_behz_lift(cfg):
    """Each step of the lift, and the lift as kernel E runs it."""
    n, q, t, jtool, dev, _, _ = cfg
    rng = np.random.default_rng(2)
    x = _res(rng, q, n, (2,))
    lifted = trns.fastbconv_m_tilde_plain(to_torch(x), dev)
    _rows_eq(lifted, lambda r: jrns.fastbconv_m_tilde(r, jtool), x)
    y = to_numpy(lifted)
    _rows_eq(trns.sm_mrq_plain(lifted, dev),
             lambda r: jrns.sm_mrq(r, jtool), y)
    _rows_eq(trns.behz_lift(to_torch(x), dev),
             lambda r: jrns.sm_mrq(jrns.fastbconv_m_tilde(r, jtool), jtool),
             x)


def test_behz_floor_and_sk(cfg):
    """Each step of the tail, and the tail as kernel E runs it: the
    product's rows in q and Bsk times t, floored, converted to q."""
    n, q, t, jtool, dev, _, _ = cfg
    rng = np.random.default_rng(3)
    bsk = jtool.base_Bsk.values
    x = _res(rng, q + bsk, n, (2,))
    floored = trns.fast_floor_plain(to_torch(x), dev)
    _rows_eq(floored, lambda r: jrns.fast_floor(r, jtool), x)
    y = to_numpy(floored)
    _rows_eq(trns.fastbconv_sk_plain(floored, dev),
             lambda r: jrns.fastbconv_sk(r, jtool), y)
    jq_bsk = jntt.RnsNttTables.from_moduli(n, q + bsk, use_mxu=False)
    _rows_eq(trns.behz_tail(to_torch(x), dev),
             lambda r: jrns.fastbconv_sk(jrns.fast_floor(
                 jpoly.rns_broadcast_scalar_mul(r, t, jq_bsk), jtool), jtool),
             x)


def test_decrypt_scale_and_round(cfg):
    """The plain version, and the card's route: kernel C's conversion with
    the t gamma premultiply folded into its constants, then kernel E's
    rounding."""
    n, q, t, jtool, dev, _, _ = cfg
    rng = np.random.default_rng(4)
    x = _res(rng, q, n, (2,))
    want = lambda r: jrns.decrypt_scale_and_round(r, jtool)
    _rows_eq(trns.decrypt_scale_and_round(to_torch(x), dev), want, x)
    tg = trns.fast_convert_plain(to_torch(x), dev.q_to_t_gamma_scaled)
    _rows_eq(trns.behz_decrypt_round(tg, dev), want, x)


def test_rns_elementwise_ops(cfg):
    n, q, t, jtool, dev, tq, jq = cfg
    rng = np.random.default_rng(5)
    a, b = _res(rng, q, n, (3,)), _res(rng, q, n, (3,))
    ta, tb, ja, jb = to_torch(a), to_torch(b), jnp.asarray(a), jnp.asarray(b)
    for port, ref in ((tpoly.rns_add(ta, tb, tq), jpoly.rns_add(ja, jb, jq)),
                      (tpoly.rns_sub(ta, tb, tq), jpoly.rns_sub(ja, jb, jq)),
                      (tpoly.rns_neg(ta, tq), jpoly.rns_neg(ja, jq))):
        np.testing.assert_array_equal(to_numpy(port), np.asarray(ref))
    x = rng.integers(0, 1 << 64, size=(3, len(q), n), dtype=np.uint64)
    scalars = [int(s) for s in rng.integers(0, 1 << 62, size=len(q))]
    np.testing.assert_array_equal(
        to_numpy(tpoly.rns_scalar_mul(to_torch(x), scalars, tq)),
        np.asarray(jpoly.rns_scalar_mul(jnp.asarray(x), scalars, jq)))
    np.testing.assert_array_equal(
        to_numpy(tpoly.rns_broadcast_scalar_mul(to_torch(x), t, tq)),
        np.asarray(jpoly.rns_broadcast_scalar_mul(jnp.asarray(x), t, jq)))


@pytest.mark.parametrize("subtract", [False, True])
def test_bfv_multiply_add_plain(cfg, subtract):
    """Includes an even t (2^41), whose exact division shifts out the
    power of two and multiplies by the odd part's inverse mod 2^64."""
    n, q, t, jtool, dev, tq, jq = cfg
    rng = np.random.default_rng(6)
    Q = 1
    for v in q:
        Q *= v
    coeff_div = tuple((Q // t) % v for v in q)
    m = rng.integers(0, t, size=(2, n), dtype=np.uint64)
    m[:, :3] = [0, 1, t - 1]
    c0 = _res(rng, q, n, (2,))
    args = (t, Q % t, coeff_div, tq)
    got = tpoly.bfv_multiply_add_plain(to_torch(m), to_torch(c0), *args,
                                       subtract=subtract)
    # the wrapper of kernel G, which runs the plain version on the CPU
    np.testing.assert_array_equal(
        to_numpy(tpoly.bfv_plain_embed(to_torch(m), to_torch(c0), *args,
                                       subtract=subtract)), to_numpy(got))
    for b in range(2):
        want = jpoly.bfv_multiply_add_plain(jnp.asarray(m[b]),
                                            jnp.asarray(c0[b]), t, Q % t,
                                            coeff_div, jq, subtract=subtract)
        np.testing.assert_array_equal(to_numpy(got[b]), np.asarray(want))


def test_keyswitch_digits(cfg):
    """Every word reduced into every prime by Barrett-64 (kernel F)."""
    n, q, t, jtool, dev, tq, _ = cfg
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 64, size=(2, len(q), n), dtype=np.uint64)
    x[0, 0, :4] = [0, 1, (1 << 64) - 1, q[0]]
    got = to_numpy(tks.keyswitch_digits(to_torch(x), tq))
    assert got.shape == (2, len(q), len(q), n)
    for j, qj in enumerate(q):
        cr = jtool.base_q.moduli[j].const_ratio
        np.testing.assert_array_equal(
            got[..., j, :], np.asarray(ju.barrett_reduce_64(
                jnp.asarray(x), qj, cr[1])))


def test_divide_and_round_q_last(cfg):
    """The BFV mod switch (kernel K) on both components at once."""
    n, q, t, jtool, dev, tq, _ = cfg
    rng = np.random.default_rng(8)
    x = _res(rng, q, n, (2,))
    x[:, :, :2] = 0
    x[:, -1, 2] = q[-1] - 1
    _rows_eq(tks.divide_and_round_q_last(to_torch(x), tq),
             lambda r: jrns.divide_and_round_q_last(r, jtool), x)


@pytest.mark.parametrize("acc_comps", [0, 1, 2])
def test_divide_round_last(cfg, acc_comps):
    """The key switch's divide by the special prime (kernel F): the same
    rounding as the mod switch, plus the fold onto an accumulator."""
    n, q, t, jtool, dev, tq, jq = cfg
    rng = np.random.default_rng(9 + acc_comps)
    x = _res(rng, q, n, (2,))
    acc = _res(rng, q[:-1], n, (acc_comps,))
    consts = tks.divide_round_consts(tq.slice(0, len(q) - 1), q[-1])
    got = to_numpy(tks.divide_round_last(
        to_torch(x), consts, to_torch(acc) if acc_comps else None))
    jsub = jntt.RnsNttTables.from_moduli(n, q[:-1], use_mxu=False)
    for b in range(2):
        want = jrns.divide_and_round_q_last(jnp.asarray(x[b]), jtool)
        if b < acc_comps:
            want = jpoly.rns_add(jnp.asarray(acc[b]), want, jsub)
        np.testing.assert_array_equal(got[b], np.asarray(want))
