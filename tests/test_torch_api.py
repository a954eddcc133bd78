"""The smaller API of troy_tpu_torch against troy_tpu: the batch encoder's
signed and raw-coefficient encodings, the context accessors, the BEHZ
auxiliary prime width, CKKS integer constants and encode statistics, and
Plaintext.coeff_count.

At n = 64 (SecurityLevel.none), both packages on the CPU, word for word
where the results are words.
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng

import troy_tpu_torch as P
from troy_tpu_torch import prng as tprng

torch.set_num_threads(1)

N = 64
SEED = 2033


def _context(mod, scheme, plain=None, bits=(40, 40, 40), **kw):
    extra = {} if scheme == "ckks" else {
        "plain_modulus": plain or mod.PlainModulus.batching(N, 20)}
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=N,
        coeff_modulus=tuple(mod.CoeffModulus.create(N, list(bits))), **extra)
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu,
                         **kw)


def _words(mod, x):
    return np.asarray(x) if mod is J else P.to_numpy(x)


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_signed_and_polynomial_encodings(scheme):
    rng = np.random.default_rng(1)
    t = int(J.PlainModulus.batching(N, 20))
    signed = rng.integers(-(t // 2), t // 2, N)
    coeffs = rng.integers(0, 2 * t, N - 5, dtype=np.uint64)   # taken mod t
    out = {}
    for mod in (J, P):
        be = mod.BatchEncoder(_context(mod, scheme))
        ps, pp = be.encode_signed(signed), be.encode_polynomial(coeffs)
        out[mod] = (_words(mod, ps.data), be.decode_signed(ps),
                    _words(mod, pp.data), be.decode_polynomial(pp),
                    be.decode_polynomial(pp, 7), pp.coeff_count)
        np.testing.assert_array_equal(out[mod][1], signed)
    for a, b in zip(out[P], out[J]):
        np.testing.assert_array_equal(a, b)


def test_polynomial_encoding_without_batching():
    """A plain modulus that is not 1 mod 2n: slots raise, raw coefficients
    work, in both packages."""
    coeffs = np.arange(N, dtype=np.uint64) * 37
    got = {}
    for mod in (J, P):
        be = mod.BatchEncoder(_context(mod, "bfv", plain=1000))
        with pytest.raises(ValueError, match="batching"):
            be.encode(coeffs)
        got[mod] = _words(mod, be.encode_polynomial(coeffs).data)
    np.testing.assert_array_equal(got[P], got[J])
    np.testing.assert_array_equal(got[P], coeffs % 1000)


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_context_accessors(scheme):
    jctx, pctx = _context(J, scheme), _context(P, scheme)
    assert pctx.last_context_data is pctx.chain[-1]
    assert pctx.last_context_data.coeff_values == \
        jctx.last_context_data.coeff_values
    for jcd, pcd in zip(jctx.chain, pctx.chain):
        assert pcd.parms_id == jcd.parms_id
        assert pctx.get_context_data_by_parms_id(pcd.parms_id) is pcd
    other = _context(P, scheme, bits=(40, 40))
    assert pctx.get_context_data_by_parms_id(other.chain[0].parms_id) is None
    if scheme != "ckks":
        j, p = jctx.plain_ntt, pctx.plain_ntt
        np.testing.assert_array_equal(P.to_numpy(p.rns.root_powers)[0],
                                      np.asarray(j.root_powers))
    else:
        assert pctx.plain_ntt is None and jctx.plain_ntt is None


@pytest.mark.parametrize("bits", [40, 61])
def test_internal_prime_bits(bits):
    """The BEHZ auxiliary base at 40-bit primes (and troy's 61): the same
    base and the same product words as troy_tpu."""
    out = {}
    for mod, prng in ((J, jprng), (P, tprng)):
        ctx = _context(mod, "bfv", internal_prime_bits=bits)
        assert ctx.internal_prime_bits == bits
        kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                              host_sampling=True)
        be = mod.BatchEncoder(ctx)
        enc = mod.Encryptor(ctx, secret_key=kg.secret_key,
                            seed=prng.seed_from_uint64(SEED + 1),
                            host_sampling=True)
        vals = np.random.default_rng(bits).integers(0, be.plain_modulus, N,
                                                    dtype=np.uint64)
        ct = enc.encrypt_symmetric(be.encode(vals))
        ev = mod.Evaluator(ctx)
        prod = ev.relinearize(ev.multiply(ct, ct), kg.create_relin_keys())
        out[mod] = (ctx.first_context_data.rns_tool.base_Bsk.values,
                    _words(mod, prod.data),
                    be.decode(mod.Decryptor(ctx, kg.secret_key).decrypt(prod)))
        want = vals.astype(object) ** 2 % be.plain_modulus
    assert out[P][0] == out[J][0]
    assert all(v.bit_length() == bits for v in out[P][0][:-1])
    np.testing.assert_array_equal(out[P][1], out[J][1])
    np.testing.assert_array_equal(out[P][2], want.astype(np.uint64))


def test_ckks_encode_int64_and_stats():
    rng = np.random.default_rng(3)
    vals = rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
    jctx, pctx = _context(J, "ckks", bits=(60, 40, 60)), \
        _context(P, "ckks", bits=(60, 40, 60))
    je, pe = J.CKKSEncoder(jctx), P.CKKSEncoder(pctx)
    for value in (0, 7, -123456789, 2 ** 40 + 3):
        np.testing.assert_array_equal(
            P.to_numpy(pe.encode_int64(value).data),
            np.asarray(je.encode_int64(value).data))
    host = J.CKKSEncoder(jctx, host=True)
    for scale in (2.0 ** 20, 2.0 ** 40, 2.0 ** 50):
        plain, stats = pe.encode_with_stats(vals, scale)
        np.testing.assert_array_equal(P.to_numpy(plain.data),
                                      P.to_numpy(pe.encode(vals, scale).data))
        _, jhost = host.encode_with_stats(vals, scale)
        _, jdev = je.encode_with_stats(vals, scale)
        assert stats.max_coeff_bit_count == jhost.max_coeff_bit_count
        assert stats.max_coeff_bit_count == jdev.max_coeff_bit_count
        assert abs(stats.max_coeff_log2 - jhost.max_coeff_log2) < 1e-9
        assert abs(stats.max_coeff_log2 - jdev.max_coeff_log2) < 1e-6


def test_plaintext_coeff_count():
    pt = P.Plaintext(data=torch.zeros(37, dtype=torch.int64))
    assert pt.coeff_count == 37
    assert J.Plaintext(data=np.zeros(37, dtype=np.uint64)).coeff_count == 37


def test_lwe_sample_through_interop():
    """An LWE sample's words out and back in: troy_tpu's extract fed to the
    port's assemble gives troy_tpu's assembled words."""
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 1000, N, dtype=np.uint64)
    sides = {}
    for mod, prng in ((J, jprng), (P, tprng)):
        ctx = _context(mod, "bfv")
        kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                              host_sampling=True)
        enc = mod.Encryptor(ctx, secret_key=kg.secret_key,
                            seed=prng.seed_from_uint64(SEED + 1),
                            host_sampling=True)
        ct = enc.encrypt_symmetric(mod.BatchEncoder(ctx).encode_polynomial(
            vals))
        sides[mod] = (ctx, mod.Evaluator(ctx), ct)
    jctx, jev, jct = sides[J]
    lwe = jev.extract_lwe(jct, 5)
    port_lwe = P.interop.lwe_ciphertext(np.asarray(lwe.c1),
                                        np.asarray(lwe.c0), lwe.level, "cpu")
    c1, c0 = P.interop.words(port_lwe)
    np.testing.assert_array_equal(c1, np.asarray(lwe.c1))
    np.testing.assert_array_equal(c0, np.asarray(lwe.c0))
    _, pev, _ = sides[P]
    np.testing.assert_array_equal(
        P.to_numpy(pev.assemble_lwe(port_lwe, 5).data),
        np.asarray(jev.assemble_lwe(lwe, 5).data))


def test_context_takes_the_reference_argument_order():
    """HeContext's first five parameters are troy_tpu's, in its order
    (troy_tpu/context.py:160-164), with ``device`` after them: a positional
    call means in the port what it means in the reference."""
    import inspect
    want = list(inspect.signature(J.HeContext).parameters)
    got = list(inspect.signature(P.HeContext).parameters)
    assert want == ["parms", "expand_mod_chain", "sec_level", "use_mxu",
                    "internal_prime_bits"]
    assert got == want + ["device"]
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, [40, 40, 40])),
        plain_modulus=P.PlainModulus.batching(N, 20))
    ctx = P.HeContext(parms, True, P.SecurityLevel.none, False, None,
                      device="cpu")
    assert ctx.use_mxu is False and ctx.internal_prime_bits is None
    assert len(ctx.chain) == 3 and ctx.device.type == "cpu"


def test_package_level_hexpoly_names():
    """The names troy_tpu/__init__.py exports beside its types."""
    from troy_tpu_torch import (hex_string_to_poly, plaintext_from_string,
                                plaintext_to_string, poly_to_hex_string,
                                valcheck)
    assert valcheck is P.valcheck
    for name in ("valcheck", "poly_to_hex_string", "hex_string_to_poly",
                 "plaintext_to_string", "plaintext_from_string"):
        assert name in P.__all__ and name in J.__all__
    pt = plaintext_from_string("3x^2 + 1Fx^1 + 5", device="cpu")
    assert plaintext_to_string(pt) == "3x^2 + 1Fx^1 + 5"
    words = hex_string_to_poly("3x^2 + 1Fx^1 + 5", 4)
    assert poly_to_hex_string(words) == "3x^2 + 1Fx^1 + 5"


def test_replace_on_every_type():
    """``replace(**changes)`` on every type that has it in troy_tpu (flax
    PyTreeNodes there): a copy of the same type with the changes, the
    original untouched."""
    ctx = _context(P, "bfv")
    kg = P.KeyGenerator(ctx, seed=tprng.seed_from_uint64(SEED),
                        host_sampling=True)
    z = torch.zeros(3, dtype=torch.int64)
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys([3])
    objects = [
        (P.Plaintext(data=z), {"scale": 2.0}),
        (kg.secret_key, {"data": z}),
        (kg.create_public_key(), {"seed": 7}),
        (P.KSwitchKeys(keys={1: z}), {"keys": {2: z}}),
        (rlk, {"keys": {}}),
        (gk, {"keys": {}}),
        (ctx.first_context_data, {"chain_index": 9}),
    ]
    for obj, changes in objects:
        out = obj.replace(**changes)
        assert type(out) is type(obj) and out is not obj
        for name, value in changes.items():
            assert getattr(out, name) is value or getattr(out, name) == value
            assert getattr(obj, name) is not value
    cd = ctx.first_context_data
    assert cd.replace(chain_index=9).ntt is cd.ntt


def test_square_takes_a():
    """Evaluator.square(a), as troy_tpu/evaluator.py:930 names it."""
    import inspect
    assert list(inspect.signature(P.Evaluator.square).parameters) == \
        list(inspect.signature(J.Evaluator.square).parameters) == ["self", "a"]
    ctx = _context(P, "bfv")
    kg = P.KeyGenerator(ctx, seed=tprng.seed_from_uint64(SEED),
                        host_sampling=True)
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=tprng.seed_from_uint64(SEED + 1),
                      host_sampling=True)
    be = P.BatchEncoder(ctx)
    vals = np.arange(N, dtype=np.uint64)
    ct = enc.encrypt_symmetric(be.encode(vals))
    sq = P.Evaluator(ctx).square(a=ct)
    t = int(ctx.first_context_data.plain_modulus)
    np.testing.assert_array_equal(
        be.decode(P.Decryptor(ctx, kg.secret_key).decrypt(sq)),
        vals * vals % t)
