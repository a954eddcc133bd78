"""The port's numpy host layer against troy_tpu's: parameter ids, NTT tables
and RnsTool fields at n = 64 and at the headline configuration, and the
host samplers and host NTT on one seed."""

import dataclasses

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng
from troy_tpu.utils import host_ntt as jhntt
from troy_tpu.utils.ntt_tables import make_ntt_tables as j_tables
from troy_tpu.utils.rns import make_rns_tool as j_rns_tool

import troy_tpu_torch as P
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.utils import host_ntt as thntt
from troy_tpu_torch.utils.ntt_tables import make_ntt_tables as t_tables
from troy_tpu_torch.utils.rns import make_rns_tool as t_rns_tool

torch.set_num_threads(1)

CONFIGS = {"n64": (64, [40, 40, 40], 17),
           "headline": (16384, [60, 40, 40, 40, 40, 60], 20)}


def _parms(mod, n, bits, t_bits):
    return mod.EncryptionParameters(
        scheme=mod.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(mod.CoeffModulus.create(n, bits)),
        plain_modulus=mod.PlainModulus.batching(n, t_bits))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both(request):
    n, bits, t_bits = CONFIGS[request.param]
    return _parms(J, n, bits, t_bits), _parms(P, n, bits, t_bits)


def test_parms_id_and_moduli(both):
    jp, tp = both
    assert tp.coeff_values == jp.coeff_values
    assert int(tp.plain_modulus) == int(jp.plain_modulus)
    assert tp.parms_id == jp.parms_id
    assert tp.drop_last().parms_id == jp.drop_last().parms_id
    for m_j, m_t in zip(jp.coeff_modulus, tp.coeff_modulus):
        assert m_t.const_ratio == m_j.const_ratio


def test_ntt_tables(both):
    jp, tp = both
    n = tp.poly_modulus_degree
    for q in tp.coeff_values + (int(tp.plain_modulus),):
        jt, tt = j_tables(n, q), t_tables(n, q)
        for f in dataclasses.fields(tt):
            a, b = getattr(tt, f.name), getattr(jt, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name


def test_rns_tool_fields(both):
    jp, tp = both
    n, t = tp.poly_modulus_degree, int(tp.plain_modulus)
    for level in range(len(tp.coeff_values)):
        q = tp.coeff_values[:len(tp.coeff_values) - level]
        jt, tt = j_rns_tool(n, q, t), t_rns_tool(n, q, t)
        for f in dataclasses.fields(tt):
            a, b = getattr(tt, f.name), getattr(jt, f.name)
            if hasattr(a, "values"):          # an RnsBase
                assert a.values == b.values, f.name
            elif hasattr(a, "matrix"):        # a BaseConverter
                assert (a.matrix, a.inv_punctured, a.inv_punctured_shoup) \
                    == (b.matrix, b.inv_punctured, b.inv_punctured_shoup), \
                    f.name
            else:
                assert a == b, f.name


def test_samplers_and_host_ntt():
    n = 64
    q = tuple(int(m) for m in P.CoeffModulus.create(n, [40, 40]))
    seed = tprng.seed_from_uint64(42)
    assert seed == jprng.seed_from_uint64(42)
    jg, tg = jprng.UniformRandomGenerator(seed), \
        tprng.UniformRandomGenerator(seed)
    np.testing.assert_array_equal(tprng.sample_poly_ternary(tg, n),
                                  jprng.sample_poly_ternary(jg, n))
    np.testing.assert_array_equal(tprng.sample_poly_cbd(tg, n),
                                  jprng.sample_poly_cbd(jg, n))
    u = tprng.sample_poly_uniform(tg, n, q)
    np.testing.assert_array_equal(u, jprng.sample_poly_uniform(jg, n, q))
    # a whole refill block and more, across the buffer boundary
    assert tg.generate(5000) == jg.generate(5000)
    np.testing.assert_array_equal(thntt.rns_ntt_forward_np(u, n, q),
                                  jhntt.rns_ntt_forward_np(u, n, q))
    np.testing.assert_array_equal(thntt.rns_ntt_inverse_np(u, n, q),
                                  jhntt.rns_ntt_inverse_np(u, n, q))
