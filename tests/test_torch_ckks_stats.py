"""The CKKS statistics of troy_tpu_torch against troy_tpu on the CPU: the
encode statistic (kernel O4's plain version, troy's gMaxReal,
src/ckks_cuda.cu:178-209, read at :386-407 for the exact magnitude check)
and the decode residual (kernel O5's plain version), with the device CKKS
surface (encode_device, decode_device, decode_device_with_stats,
decode_max_error).

CKKS at n = 64 (q = {40,40,40}) and 4096 (q = {60,40,40,60}),
SecurityLevel.none, slot vectors from numpy seeds, scales 2^30 and 2^40.
The port rounds at the full scale (its exponent is 0), troy_tpu splits the
scale above 2^44, so the two are compared by what they mean:
max_coeff_bit_count exactly, max_coeff_log2 within 1e-9, the statistic
(max_abs_small 2^exponent) within 1 (the two packages' transforms sum in
different orders, which can move the rounding of one coefficient). At
scales 2^55 and 2^60 the port's statistic equals, exactly, the largest
coefficient of its own plaintext composed back on the host (troy_tpu's
split can be off there, ROADMAP queue 3). The decode residual: the port's
equals, exactly, troy_tpu's expression (troy_tpu/ops/embedding.py:656-660)
over troy_tpu's slot table applied to the port's own transform; with
host=True the two packages' residuals are equal; the port's plain O5 lies
within a factor of 8 of troy_tpu's device residual (their transforms round
differently: 0.25-0.36 of it at these inputs); all lie in (0, 1e-8].
"""

import math

import numpy as np
import pytest
import torch

import troy_tpu as J

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch.ops import embedding as emb

torch.set_num_threads(2)

CONFIGS = {"n64": (64, [40, 40, 40]), "n4096": (4096, [60, 40, 40, 60])}
SCALES = (2.0 ** 30, 2.0 ** 40)
RESIDUAL_BOUND = 1e-8
RESIDUAL_FACTOR = 8.0


def _ctx(mod, name):
    n, bits = CONFIGS[name]
    parms = mod.EncryptionParameters(
        scheme=mod.SchemeType.ckks, poly_modulus_degree=n,
        coeff_modulus=tuple(mod.CoeffModulus.create(n, bits)))
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both(request):
    name = request.param
    n = CONFIGS[name][0]
    jctx, pctx = _ctx(J, name), _ctx(P, name)
    rng = np.random.default_rng(n)
    vals = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    return {"n": n, "vals": vals, "jctx": jctx, "pctx": pctx,
            "je": J.CKKSEncoder(jctx), "jhost": J.CKKSEncoder(jctx, host=True),
            "pe": P.CKKSEncoder(pctx), "phost": P.CKKSEncoder(pctx, host=True)}


def _stat(stats) -> float:
    return float(np.asarray(stats.max_abs_small)) * 2.0 ** stats.exponent


def _composed_max(encoder, plain) -> float:
    """The largest |coefficient| of a plaintext composed back exactly on
    the host (the port's host oracle)."""
    cd = encoder.context.get_context_data(plain.level)
    return float(np.max(np.abs(encoder._compose_centered_host(plain, cd))))


@pytest.mark.parametrize("scale", SCALES, ids=["2^30", "2^40"])
def test_encode_stats_match_troy_tpu(both, scale):
    vals = both["vals"]
    plain, stats = both["pe"].encode_with_stats(vals, scale)
    np.testing.assert_array_equal(
        interop.to_numpy(plain.data),
        interop.to_numpy(both["pe"].encode(vals, scale).data))
    assert stats.exponent == 0 and torch.is_tensor(stats.max_abs_small)
    for other in (both["je"], both["jhost"]):
        _, jstats = other.encode_with_stats(vals, scale)
        assert stats.max_coeff_bit_count == jstats.max_coeff_bit_count
        assert abs(stats.max_coeff_log2 - jstats.max_coeff_log2) < 1e-9
        assert abs(_stat(stats) - _stat(jstats)) <= 1
    # the statistic is the largest coefficient the words hold
    assert float(stats.max_abs_small) == _composed_max(both["phost"], plain)


@pytest.mark.parametrize("scale", (2.0 ** 55, 2.0 ** 60),
                         ids=["2^55", "2^60"])
def test_encode_stats_at_large_scales_equal_the_host_oracle(both, scale):
    plain, stats = both["pe"].encode_with_stats(both["vals"], scale)
    want = _composed_max(both["phost"], plain)
    assert float(stats.max_abs_small) == want
    bits = (math.ceil(math.log2(want)) if want > 1 else 0) + 1
    assert stats.max_coeff_bit_count == bits
    _, hstats = both["phost"].encode_with_stats(both["vals"], scale)
    assert stats.max_coeff_bit_count == hstats.max_coeff_bit_count


def test_decode_residuals_are_tiny(both):
    """On four slot vectors (the fixture's and three more seeded), so that
    a residual over only part of the slots shows."""
    scale, n = 2.0 ** 40, both["n"]
    pe, je = both["pe"], both["je"]
    rng = np.random.default_rng(n + 1)
    for vals in [both["vals"]] + [
            rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
            for _ in range(3)]:
        plain = pe.encode(vals, scale)
        re, im, err = pe.decode_device_with_stats(plain)
        assert err.dim() == 0 and err.dtype == torch.float64
        e = float(err)
        assert 0.0 < e <= RESIDUAL_BOUND
        assert pe.decode_max_error(plain) == e
        np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), vals,
                                   atol=1e-8)
        # troy_tpu's residual expression over troy_tpu's slot table, on
        # the port's own full transform V: the partner index, the signs
        # and every slot, exactly
        t = pe._emb
        coeffs = pe._decode_coeffs(plain, pe.context.get_context_data(
            plain.level))
        v = emb._four_step_plain(coeffs * t.twist, t.w1d, t.twd, t.w2d,
                                 t).numpy()
        idx = np.asarray(je._emb.slot_index)
        want = max(np.max(np.abs(v.real[idx] - v.real[n - 1 - idx])),
                   np.max(np.abs(v.imag[idx] + v.imag[n - 1 - idx])))
        assert e == want
        # troy_tpu's, on the same words: the host oracles agree exactly,
        # the device transforms to within RESIDUAL_FACTOR
        jplain = J.Plaintext(data=np.asarray(interop.to_numpy(plain.data)),
                             level=plain.level, is_ntt_form=True,
                             scale=scale)
        host = both["phost"].decode_max_error(plain)
        assert host == both["jhost"].decode_max_error(jplain)
        assert 0.0 < host <= RESIDUAL_BOUND
        jd = je.decode_max_error(jplain)
        assert 0.0 < jd <= RESIDUAL_BOUND
        assert max(e, jd) <= RESIDUAL_FACTOR * min(e, jd)


def test_device_surface_gives_the_words_of_encode_and_decode(both):
    vals, scale, pe = both["vals"], 2.0 ** 40, both["pe"]
    plain = pe.encode(vals, scale)
    dev = pe.encode_device(torch.from_numpy(vals.real.copy()),
                           torch.from_numpy(vals.imag.copy()), scale,
                           max_abs=float(np.max(np.abs(vals))))
    assert torch.equal(dev.data, plain.data)
    assert (dev.level, dev.is_ntt_form, dev.scale) == \
        (plain.level, True, scale)
    re, im = pe.decode_device(plain)
    slots = pe.decode(plain)
    np.testing.assert_array_equal(re.numpy(), slots.real)
    np.testing.assert_array_equal(im.numpy(), slots.imag)
    re2, im2, _ = pe.decode_device_with_stats(plain)
    assert torch.equal(re, re2) and torch.equal(im, im2)
    # and troy_tpu's device surface on the same inputs
    jdev = both["je"].encode_device(vals.real, vals.imag, scale,
                                    max_abs=float(np.max(np.abs(vals))))
    np.testing.assert_array_equal(np.asarray(jdev.data),
                                  interop.to_numpy(plain.data))
    with pytest.raises(ValueError, match="too large"):
        pe.encode_device(re, im, scale,
                         max_abs=pe.context.first_context_data
                         .total_coeff_modulus / scale)


def test_borderline_and_too_large_encodes(both):
    """tests/test_ckks_stats.py's cases: one slot at 4Q/scale passes the
    exact check though scale * max|v| fails the host bound; every slot at
    Q/scale raises in both packages."""
    n, pe = both["n"], both["pe"]
    Q = both["pctx"].first_context_data.total_coeff_modulus
    scale = 2.0 ** 45
    vals = np.zeros(n // 2, dtype=np.complex128)
    vals[0] = 4.0 * Q / scale
    plain = pe.encode(vals, scale)
    np.testing.assert_allclose(pe.decode(plain)[0].real, vals[0].real,
                               rtol=1e-10)
    jplain = both["je"].encode(vals, scale)
    np.testing.assert_allclose(both["je"].decode(jplain)[0].real,
                               vals[0].real, rtol=1e-10)
    bad = np.full(n // 2, Q / scale, dtype=np.complex128)
    for encoder in (pe, both["phost"], both["je"], both["jhost"]):
        with pytest.raises(ValueError, match="too large"):
            encoder.encode(bad, scale)
