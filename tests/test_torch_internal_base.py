"""The narrow internal (BEHZ auxiliary) base of troy_tpu_torch, on the CPU.

The twin of tests/test_internal_base.py against the port's context and
its ``utils/rns.py`` tool. ``HeContext(..., internal_prime_bits=b)`` draws
the Bsk, m_sk and gamma primes at b bits instead of troy's 61
(rns.cpp:628-630 getPrimes(61)); the base is sized on exact products
(prod(B) m_sk > 2^33 t Q), and decryptions against plaintext models gate
it across the three schemes. The default stays word-equal to troy's draw.
chip_smoke.py's phase 36 runs the BFV multiply, relinearize and decrypt at
40 and 48 bits at n = 16384 on the card (kernels E and ACi). No JAX.
"""

import numpy as np
import pytest
import torch

import troy_tpu_torch as P
from troy_tpu_torch import prng as rnd
from troy_tpu_torch.modulus import INTERNAL_MOD_BIT_COUNT, Modulus
from troy_tpu_torch.utils.rns import RnsBase, RnsTool, make_rns_tool

torch.set_num_threads(1)

N = 64
SEED = rnd.seed_from_uint64(0xBA5E)


def _bfv_ctx(bits):
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, [40, 30, 40])),
        plain_modulus=P.PlainModulus.batching(N, 17))
    return parms, P.HeContext(parms, sec_level=P.SecurityLevel.none,
                              internal_prime_bits=bits, device="cpu")


# ---------------------------------------------------------------------------
# sizing and parity
# ---------------------------------------------------------------------------

def test_default_is_reference_parity():
    """No internal_prime_bits (or 61) reproduces troy's draw word for word:
    the fixture suites depend on it."""
    parms, ctx = _bfv_ctx(None)
    _, ctx61 = _bfv_ctx(61)
    t0 = ctx.key_context_data.rns_tool
    t1 = ctx61.key_context_data.rns_tool
    assert t0.base_Bsk.values == t1.base_Bsk.values
    assert t0.gamma == t1.gamma and t0.m_sk == t1.m_sk
    assert all(v.bit_length() == INTERNAL_MOD_BIT_COUNT
               for v in t0.base_Bsk.values)
    # one cache entry per width: the tools must not alias
    assert t0 == make_rns_tool(N, tuple(parms.coeff_values),
                               int(parms.plain_modulus))
    t40 = make_rns_tool(N, tuple(parms.coeff_values),
                        int(parms.plain_modulus), 40)
    assert t40 != t0 and hash(t40) != hash(t0)


@pytest.mark.parametrize("bits", [48, 40])
def test_narrow_base_sizing(bits):
    _, ctx = _bfv_ctx(bits)
    for cd in ctx.chain:
        tool = cd.rns_tool
        assert all(v.bit_length() == bits for v in tool.base_Bsk.values)
        assert tool.gamma.bit_length() == bits
        # the exact-product bound: prod(B) m_sk > 2^33 t Q
        prod = 1
        for v in tool.base_Bsk.values:
            prod *= v
        assert prod > (tool.t * tool.base_q.base_prod) << 33
        # the aux primes never collide with the data primes or t
        assert not (set(tool.base_Bsk.values)
                    & (set(tool.base_q.values) | {tool.t}))
        # the device constants are built over the same primes
        assert [int(q) for q in cd.rns.bsk.q.tolist()] \
            == list(tool.base_Bsk.values)


def test_narrow_base_skips_colliding_primes():
    """With 40-bit q primes and a 40-bit internal base, the draw skips any
    prime already in q (Q^-1 mod b_i must exist)."""
    q40 = P.CoeffModulus.create(N, [40, 40, 40])
    tool = RnsTool(n=N, base_q=RnsBase(tuple(q40)),
                   t=int(P.PlainModulus.batching(N, 17)),
                   internal_prime_bits=40)
    qvals = set(int(m) for m in q40)
    assert not (set(tool.base_Bsk.values) | {tool.gamma}) & qvals


def test_narrow_base_skips_factors_of_composite_t():
    """A composite plain modulus can hold a prime of the internal base's
    width; the draw skips t's prime factors too, or gamma and m_sk are not
    invertible mod t. End to end: the square of a coefficient-encoded
    polynomial decrypts to the exact model."""
    from troy_tpu_torch.utils import numth
    n = 64
    p1 = numth.get_primes(2 * n, 40, 1)[0]
    t = p1 * 3
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [50, 50, 50])),
        plain_modulus=Modulus(t))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                      internal_prime_bits=40, device="cpu")
    rt = ctx.first_context_data.rns_tool
    assert rt.gamma % p1 and rt.m_sk % p1
    assert all(b % p1 for b in rt.base_B.values)
    kg = P.KeyGenerator(ctx, seed=SEED)
    enc = P.Encryptor(ctx, secret_key=kg.secret_key, seed=SEED)
    dec = P.Decryptor(ctx, kg.secret_key)
    be = P.BatchEncoder(ctx)
    ev = P.Evaluator(ctx)
    a = np.arange(n, dtype=np.uint64)
    sq = ev.relinearize(
        ev.multiply(enc.encrypt_symmetric(be.encode_polynomial(a)),
                    enc.encrypt_symmetric(be.encode_polynomial(a))),
        kg.create_relin_keys())
    conv = [0] * (2 * n)
    for i in range(n):
        for j in range(n):
            conv[i + j] += int(a[i]) * int(a[j])
    want = np.array([(conv[i] - conv[i + n]) % t for i in range(n)],
                    dtype=np.uint64)
    np.testing.assert_array_equal(
        be.decode_polynomial(dec.decrypt(sq)), want)


def test_invalid_width_rejected():
    with pytest.raises(ValueError):
        RnsTool(n=N, base_q=RnsBase((Modulus(int(P.CoeffModulus.create(
            N, [40])[0])),)), t=0, internal_prime_bits=20)


# ---------------------------------------------------------------------------
# decryptions against plaintext models (all three schemes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [48, 40])
def test_bfv_narrow_fuzz(bits):
    parms, ctx = _bfv_ctx(bits)
    t = int(parms.plain_modulus)
    kg = P.KeyGenerator(ctx, seed=SEED)
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1])
    enc = P.Encryptor(ctx, secret_key=kg.secret_key, seed=SEED)
    dec = P.Decryptor(ctx, kg.secret_key)
    be = P.BatchEncoder(ctx)
    ev = P.Evaluator(ctx)
    rng = np.random.default_rng(7 + bits)
    for trial in range(3):
        a = rng.integers(0, t, N, dtype=np.uint64)
        b = rng.integers(0, t, N, dtype=np.uint64)
        ca = enc.encrypt_symmetric(be.encode(a))
        cb = enc.encrypt_symmetric(be.encode(b))
        prod = ev.relinearize(ev.multiply(ca, cb), rlk)
        model = (a.astype(object) * b.astype(object)) % t
        assert np.array_equal(be.decode(dec.decrypt(prod)), model)
        # a second multiply (a deeper product), then the mod switch
        prod2 = ev.relinearize(ev.multiply(prod, ca), rlk)
        model2 = (model * a.astype(object)) % t
        ms = ev.mod_switch_to_next(prod2)
        assert np.array_equal(be.decode(dec.decrypt(ms)), model2)
        # a rotation through the narrow-base context's Galois keys
        rot = ev.rotate_rows(prod, 1, gk)
        half = N // 2
        want = np.concatenate([np.roll(model[:half], -1),
                               np.roll(model[half:], -1)])
        assert np.array_equal(be.decode(dec.decrypt(rot)), want)


@pytest.mark.parametrize("bits", [48, 40])
def test_bgv_ckks_narrow_fuzz(bits):
    # BGV: multiply, relinearize and mod switch under a narrow-base context
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bgv, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, [40, 30, 40])),
        plain_modulus=P.PlainModulus.batching(N, 17))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                      internal_prime_bits=bits, device="cpu")
    t = int(parms.plain_modulus)
    kg = P.KeyGenerator(ctx, seed=SEED)
    rlk = kg.create_relin_keys()
    enc = P.Encryptor(ctx, secret_key=kg.secret_key, seed=SEED)
    dec = P.Decryptor(ctx, kg.secret_key)
    be = P.BatchEncoder(ctx)
    ev = P.Evaluator(ctx)
    a = (np.arange(N, dtype=np.uint64) * 31 + 5) % t
    b = (np.arange(N, dtype=np.uint64) * 17 + 3) % t
    prod = ev.relinearize(ev.multiply(enc.encrypt_symmetric(be.encode(a)),
                                      enc.encrypt_symmetric(be.encode(b))),
                          rlk)
    model = (a.astype(object) * b.astype(object)) % t
    assert np.array_equal(be.decode(dec.decrypt(prod)), model)
    ms = ev.mod_switch_to_next(prod)
    assert np.array_equal(be.decode(dec.decrypt(ms)), model)

    # CKKS: multiply and rescale under a narrow-base context
    cparms = P.EncryptionParameters(
        scheme=P.SchemeType.ckks, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, [50, 30, 50])))
    cctx = P.HeContext(cparms, sec_level=P.SecurityLevel.none,
                       internal_prime_bits=bits, device="cpu")
    ckg = P.KeyGenerator(cctx, seed=SEED)
    crlk = ckg.create_relin_keys()
    cenc = P.Encryptor(cctx, secret_key=ckg.secret_key, seed=SEED)
    cdec = P.Decryptor(cctx, ckg.secret_key)
    ce = P.CKKSEncoder(cctx)
    cev = P.Evaluator(cctx)
    vals = (np.arange(N // 2) % 9) * 0.125 + 0.25
    scale = 2.0 ** 30
    c1 = cenc.encrypt_symmetric(ce.encode(vals, scale=scale))
    c2 = cenc.encrypt_symmetric(ce.encode(vals[::-1].copy(), scale=scale))
    p = cev.rescale_to_next(cev.relinearize(cev.multiply(c1, c2), crlk))
    got = np.real(ce.decode(cdec.decrypt(p)))
    np.testing.assert_allclose(got, vals * vals[::-1], atol=1e-3)
