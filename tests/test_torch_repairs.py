"""Where troy_tpu_torch is right and troy_tpu is not, judged by decryption.

* BFV in NTT form through a key switch: troy_tpu's ``_switch_key_contract``
  picks its output domain by scheme (troy_tpu/evaluator.py:302, :345), so
  its relinearize, rotate_rows and apply_keyswitching of an NTT-form BFV
  ciphertext decrypt wrong; the port divides in the ciphertext's domain.
* CKKS encode at scale * max|v| > 2^44: troy_tpu's device encoder rounds
  at a split scale s_small 2^e (troy_tpu/ckks.py:146-149) and is off by up
  to 2^(e-1); the port rounds exactly. Held against an mpmath oracle of
  the exact coefficients, and against troy_tpu by decoding.
* BGV packing: troy_tpu folds in the coefficient domain with a key switch
  that returns NTT form; its packed ciphertext decrypts wrong.

At n = 64 (SecurityLevel.none), both packages on the CPU.
"""

import mpmath
import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng

import troy_tpu_torch as P
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.ops import embedding as temb
from troy_tpu_torch.ops import ntt as tntt

torch.set_num_threads(1)

N = 64
SEED = 2034


def _bfv(mod, prng, bits=(40, 40, 40), scheme="bfv"):
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=N,
        coeff_modulus=tuple(mod.CoeffModulus.create(N, list(bits))),
        plain_modulus=mod.PlainModulus.batching(N, 20))
    on_cpu = {"device": "cpu"} if mod is P else {}
    ctx = mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)
    kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                          host_sampling=True)
    enc = mod.Encryptor(ctx, secret_key=kg.secret_key,
                        seed=prng.seed_from_uint64(SEED + 1),
                        host_sampling=True)
    return (ctx, kg, enc, mod.Evaluator(ctx), mod.BatchEncoder(ctx),
            mod.Decryptor(ctx, kg.secret_key))


def test_bfv_ntt_form_key_switch_decrypts():
    ctx, kg, enc, ev, be, dec = _bfv(P, tprng)
    t = be.plain_modulus
    rng = np.random.default_rng(1)
    a = rng.integers(0, t, N, dtype=np.uint64)
    ct = enc.encrypt_symmetric(be.encode(a))
    prod = ev.multiply(ct, ct)
    square = (a.astype(object) ** 2 % t).astype(np.uint64)
    rows = a.reshape(2, N // 2)
    other = P.KeyGenerator(ctx, seed=tprng.seed_from_uint64(SEED + 5),
                           host_sampling=True)
    switched = ev.apply_keyswitching(ev.transform_to_ntt(ct),
                                     other.create_keyswitch_key(kg.secret_key))
    checks = {
        "relinearize": (ev.relinearize(ev.transform_to_ntt(prod),
                                       kg.create_relin_keys()), square, dec),
        "rotate_rows": (ev.rotate_rows(ev.transform_to_ntt(ct), 1,
                                       kg.create_galois_keys(steps=[1])),
                        np.roll(rows, -1, axis=1).reshape(-1), dec),
        "apply_keyswitching": (switched, a,
                               P.Decryptor(ctx, other.secret_key)),
    }
    for what, (got, want, d) in checks.items():
        assert got.is_ntt_form, what
        np.testing.assert_array_equal(be.decode(d.decrypt(got)), want,
                                      err_msg=what)
        assert d.invariant_noise_budget(got) > 0, what
    # troy_tpu's relinearize of the same NTT-form product decrypts wrong
    jctx, jkg, jenc, jev, jbe, jdec = _bfv(J, jprng)
    jct = jenc.encrypt_symmetric(jbe.encode(a))
    jrel = jev.relinearize(jev.transform_to_ntt(jev.multiply(jct, jct)),
                           jkg.create_relin_keys())
    assert not np.array_equal(jbe.decode(jdec.decrypt(jrel)), square)


def _exact_coeffs(values: np.ndarray, scale: float) -> list:
    """The encoder's coefficients round(scale Re((1/n) sum_k V_k w^-kt
    zeta^-t)), w = exp(2 pi i / n), zeta = exp(i pi / n), with V the
    conjugate-symmetric slot vector, in 60-digit arithmetic (mpmath), as
    Python integers."""
    mpmath.mp.dps = 60
    idx = temb.slot_index(N)
    v = [mpmath.mpc(0)] * N
    for i, x in enumerate(values):
        v[idx[i]] = mpmath.mpc(float(x.real), float(x.imag))
        v[N - 1 - idx[i]] = mpmath.mpc(float(x.real), -float(x.imag))
    out = []
    for t in range(N):
        acc = mpmath.fsum(v[k] * mpmath.expjpi(-mpmath.mpf(2 * k * t) / N)
                          for k in range(N))
        u = acc / N * mpmath.expjpi(-mpmath.mpf(t) / N)
        out.append(int(mpmath.nint(u.real * mpmath.mpf(scale))))
    return out


def _composed(mod, plain, cd) -> list:
    """A CKKS plaintext's coefficients, centred, as Python integers."""
    if mod is J:
        from troy_tpu.ops import ntt as jntt
        res = np.asarray(jntt.rns_ntt_inverse(plain.data, cd.ntt))
    else:
        res = P.to_numpy(tntt.rns_ntt_inverse(plain.data, cd.ntt))
    q = cd.coeff_values
    Q = 1
    for x in q:
        Q *= x
    out = []
    for t in range(N):
        acc = sum(int(res[i, t]) * (Q // qi) * pow(Q // qi % qi, -1, qi)
                  for i, qi in enumerate(q)) % Q
        out.append(acc - Q if acc > Q // 2 else acc)
    return out


@pytest.mark.parametrize("log_scale", [55, 60, 80])
def test_ckks_encode_at_large_scales(log_scale):
    """The port's encode within 1 + scale 2^-50 of the exact coefficients
    (the float64 transform's own error; troy_tpu's split-scale rounding is
    far beyond it at 2^80), and its decode as close to the slots as
    troy_tpu's."""
    scale = 2.0 ** log_scale
    rng = np.random.default_rng(log_scale)
    vals = rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
    exact = _exact_coeffs(vals, scale)
    err, dec_err = {}, {}
    for mod in (J, P):
        parms = mod.EncryptionParameters(
            scheme=mod.SchemeType.ckks, poly_modulus_degree=N,
            coeff_modulus=tuple(mod.CoeffModulus.create(N, [60] * 4)))
        on_cpu = {"device": "cpu"} if mod is P else {}
        ctx = mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                            **on_cpu)
        encoder = mod.CKKSEncoder(ctx)
        plain = encoder.encode(vals, scale)
        got = _composed(mod, plain, ctx.get_context_data(plain.level))
        err[mod] = max(abs(a - b) for a, b in zip(got, exact))
        dec_err[mod] = float(np.abs(encoder.decode(plain) - vals).max())
    assert err[P] <= 1 + scale * 2.0 ** -50, err
    assert err[P] <= err[J], err
    assert dec_err[P] <= dec_err[J] * (1 + 1e-6) + 1e-15, dec_err
    if log_scale == 80:
        assert err[J] > 1 + scale * 2.0 ** -50, err


def test_bgv_pack_decrypts():
    """n = 64, q = {40, 40, 40}, t = batching(64, 20): the terms 0, 3, 7,
    11 of encode_polynomial(arange(64) + 5), extracted and packed with the
    automorphism keys, decrypt to [5, 8, 12, 16] at stride 16 in the port
    and to other values in troy_tpu."""
    want = [5, 8, 12, 16]
    got = {}
    for mod, prng in ((J, jprng), (P, tprng)):
        ctx, kg, enc, ev, be, dec = _bfv(mod, prng, scheme="bgv")
        ct = enc.encrypt_symmetric(be.encode_polynomial(np.arange(N) + 5))
        lwes = [ev.extract_lwe(ct, i) for i in (0, 3, 7, 11)]
        packed = ev.pack_lwe_ciphertexts(lwes,
                                         kg.create_automorphism_keys())
        out = be.decode_polynomial(dec.decrypt(packed))
        got[mod] = [int(x) for x in out[::16][:4]]
        if mod is P:
            assert not packed.is_ntt_form
            assert np.count_nonzero(out) == 4
            assert dec.invariant_noise_budget(packed) > 0
    assert got[P] == want
    assert got[J] != want
