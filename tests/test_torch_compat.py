"""troy_tpu_torch.compat, troy's binder API on the port, on the CPU.

The binder's whole surface (tests/test_binder_surface.py's SURFACE), the
overloads it dispatches by argument type, the scenarios of
tests/test_compat.py and tests/test_binder_parity.py (troy's own
binder/test.py two-party protocol and binder/timetest.py's op surface) at
n <= 4096 with ``device="cpu"`` and SecurityLevel.none, troy's wire through
``save(context, wire="troy")``, and the bytes of the JAX package's shim
(``pytroy``): seeded keys saved by either shim are byte-equal in both
wires, and a ciphertext saved by ``pytroy``, loaded in both shims,
multiplied and relinearized, saves to equal bytes.
"""

import inspect
import os
import random

import numpy as np
import pytest
import torch

import pytroy as jpytroy
from test_binder_surface import SURFACE

import troy_tpu_torch.compat as pytroy

torch.set_num_threads(2)

N = 64
DATA = os.path.join(os.path.dirname(__file__), "data", "ref_wire_n64.bin")


def _params(scheme, n=N, bits=(40, 40, 40), t=None, mod=pytroy):
    parms = mod.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(mod.CoeffModulus.create(n, list(bits)))
    if scheme != mod.SchemeType.ckks:
        parms.set_plain_modulus(mod.PlainModulus.batching(n, 16)
                                if t is None else t)
    return parms


def _context(parms):
    return pytroy.SEALContext(parms, True, pytroy.SecurityLevel.none,
                              device="cpu")


# ---------------------------------------------------------------------------
# the surface and its overloads (tests/test_binder_surface.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls_name", sorted(k for k in SURFACE if k))
def test_class_surface(cls_name):
    cls = getattr(pytroy, cls_name)
    obj = cls(17) if cls_name == "Modulus" else cls
    missing = [m for m in SURFACE[cls_name] if not hasattr(obj, m)]
    assert not missing, f"compat.{cls_name} missing: {missing}"
    if cls_name == "Modulus":
        assert obj.value() == 17 and obj.is_prime()


def test_module_surface_and_initialize_kernel():
    """troy's initialize_kernel() takes no argument; it builds and loads
    the kernels on the card and raises without one."""
    assert all(hasattr(pytroy, m) for m in SURFACE[None])
    assert not inspect.signature(pytroy.initialize_kernel).parameters
    if torch.cuda.is_available():
        pytroy.initialize_kernel()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pytroy.initialize_kernel()


@pytest.fixture(scope="module")
def bfv_setup():
    ctx = _context(_params(pytroy.SchemeType.bfv))
    kg = pytroy.KeyGenerator(ctx)
    encryptor = pytroy.Encryptor(ctx, kg.create_public_key())
    encryptor.set_secret_key(kg.secret_key())
    decryptor = pytroy.Decryptor(ctx, kg.secret_key())
    return (ctx, kg, encryptor, decryptor, pytroy.BatchEncoder(ctx),
            pytroy.Evaluator(ctx))


def test_matmul_overload_dispatch(bfv_setup):
    ctx, kg, encryptor, decryptor, encoder, ev = bfv_setup
    t = encoder._inner.plain_modulus
    rng = np.random.default_rng(7)
    x = rng.integers(0, t, (2, 3), dtype=np.uint64)
    w = rng.integers(0, t, (3, 4), dtype=np.uint64)
    expect = (x.astype(object) @ w.astype(object)) % t
    helper = pytroy.MatmulHelper(2, 3, 4, N, 0, False)
    x_pt, w_pt = helper.encode_inputs(encoder, x), \
        helper.encode_weights(encoder, w)
    x_ct, w_ct = x_pt.encrypt_symmetric(encryptor), \
        w_pt.encrypt_symmetric(encryptor)
    for a, b in [(x_ct, w_pt), (x_ct, w_ct), (x_pt, w_ct)]:
        y = helper.decrypt_outputs(encoder, decryptor,
                                   helper.matmul(ev, a, b))
        np.testing.assert_array_equal(np.asarray(y, dtype=object) % t,
                                      expect)
    with pytest.raises(TypeError):
        helper.matmul(ev, x_pt, w_pt)


def test_conv2d_overload_dispatch(bfv_setup):
    ctx, kg, encryptor, decryptor, encoder, ev = bfv_setup
    t = encoder._inner.plain_modulus
    rng = np.random.default_rng(8)
    B, H, W, KH, KW, CI, CO = 1, 4, 4, 2, 2, 2, 2
    x = rng.integers(0, 16, (B, CI, H, W), dtype=np.uint64)
    w = rng.integers(0, 16, (CO, CI, KH, KW), dtype=np.uint64)
    oh, ow = H - KH + 1, W - KW + 1
    expect = np.zeros((B, CO, oh, ow), dtype=object)
    for co in range(CO):
        for i in range(oh):
            for j in range(ow):
                expect[0, co, i, j] = int(
                    (x[0, :, i:i + KH, j:j + KW].astype(object)
                     * w[co].astype(object)).sum()) % t
    helper = pytroy.Conv2dHelper(B, H, W, KH, KW, CI, CO, N, 0)
    x_pt, w_pt = helper.encode_inputs(encoder, x), \
        helper.encode_weights(encoder, w)
    x_ct, w_ct = x_pt.encrypt_symmetric(encryptor), \
        w_pt.encrypt_symmetric(encryptor)
    for a, b in [(x_ct, w_pt), (x_ct, w_ct), (x_pt, w_ct)]:
        y = helper.decrypt_outputs(encoder, decryptor,
                                   helper.conv2d(ev, a, b))
        np.testing.assert_array_equal(np.asarray(y, dtype=object) % t,
                                      expect)
    with pytest.raises(TypeError):
        helper.conv2d(ev, x_pt, w_pt)


def test_evaluator_ct_pt_overload_dispatch(bfv_setup):
    ctx, kg, encryptor, decryptor, encoder, ev = bfv_setup
    pt = encoder.encode_polynomial(np.arange(N, dtype=np.uint64))
    ct = encryptor.encrypt(pt)
    ct2 = ev.mod_switch_to_next(ct)
    assert isinstance(ct2, pytroy.Ciphertext)
    assert isinstance(ev.mod_switch_to(ct, ct2.parms_id()),
                      pytroy.Ciphertext)
    ct_ntt = ev.transform_to_ntt(ct)
    assert isinstance(ct_ntt, pytroy.Ciphertext) and ct_ntt.is_ntt_form()
    pt_ntt = ev.transform_to_ntt(pt, ctx.first_parms_id())
    assert isinstance(pt_ntt, pytroy.Plaintext) and pt_ntt.is_ntt_form()
    dec = encoder.decode_polynomial(decryptor.decrypt(
        ev.multiply_plain(ct, pt)))
    dec2 = encoder.decode_polynomial(decryptor.decrypt(
        ev.transform_from_ntt(ev.multiply_plain(ct_ntt, pt_ntt))))
    np.testing.assert_array_equal(dec, dec2)
    # the plaintext overloads of the mod switch
    pt_next = ev.mod_switch_to_next(pt_ntt)
    assert isinstance(pt_next, pytroy.Plaintext)
    assert pt_next.parms_id() == ct2.parms_id()
    out = pytroy.Plaintext()
    assert ev.mod_switch_to(pt_ntt, ct2.parms_id(), out) is out


def test_keygen_and_encryptor_overload_dispatch(bfv_setup):
    ctx, kg, encryptor, decryptor, encoder, ev = bfv_setup
    gk_one = kg.create_galois_keys([1])
    assert isinstance(kg.create_galois_keys(), pytroy.GaloisKeys)
    out = pytroy.GaloisKeys()
    assert kg.create_galois_keys([1], out) is out
    vals = np.zeros(N, dtype=np.uint64)
    vals[:8] = np.arange(8)
    ct = encryptor.encrypt(encoder.encode(vals))
    out = encoder.decode(decryptor.decrypt(ev.rotate_rows(ct, 1, gk_one)))
    np.testing.assert_array_equal(out[:7], vals[1:8])
    for z in (encryptor.encrypt_zero(),
              encryptor.encrypt_zero(ev.mod_switch_to_next(ct).parms_id()),
              encryptor.encrypt_zero_symmetric()):
        assert np.all(encoder.decode(decryptor.decrypt(z)) == 0)


# ---------------------------------------------------------------------------
# tests/test_compat.py's scenarios
# ---------------------------------------------------------------------------

def test_ckks_two_party_protocol():
    ctx_a = _context(_params(pytroy.SchemeType.ckks))
    enc_a = pytroy.CKKSEncoder(ctx_a)
    kg = pytroy.KeyGenerator(ctx_a)
    pk, rlk = kg.create_public_key(), kg.create_relin_keys()
    encryptor = pytroy.Encryptor(ctx_a, pk)
    decryptor = pytroy.Decryptor(ctx_a, kg.secret_key())
    pk_bytes, rlk_bytes = pk.save(), rlk.save()
    ctx_b = _context(_params(pytroy.SchemeType.ckks))
    pk_b, rlk_b = pytroy.PublicKey(), pytroy.RelinKeys()
    pk_b.load(pk_bytes)
    rlk_b.load(rlk_bytes)
    ev_b = pytroy.Evaluator(ctx_b)
    m1, m2 = [1.0, 2.0, 3.0, 4.0], [0.5, 0.6, 0.7, 0.8]
    p1, p2 = pytroy.Plaintext(), pytroy.Plaintext()
    enc_a.encode(m1, 1 << 40, p1)
    enc_a.encode(m2, 1 << 40, p2)
    c1, c2 = pytroy.Ciphertext(), pytroy.Ciphertext()
    encryptor.encrypt(p1, c1)
    encryptor.encrypt(p2, c2)
    c1_b, c2_b = pytroy.Ciphertext(), pytroy.Ciphertext()
    c1_b.load(c1.save(), ctx_b)
    c2_b.load(c2.save(), ctx_b)
    ev_b.multiply_inplace(c1_b, c2_b)
    ev_b.relinearize_inplace(c1_b, rlk_b)
    c = pytroy.Ciphertext()
    c.load(c1_b.save(), ctx_a)
    p = pytroy.Plaintext()
    decryptor.decrypt(c, p)
    np.testing.assert_allclose(enc_a.decode(p)[:4].real,
                               np.array(m1) * np.array(m2), atol=1e-2)


def test_bfv_inplace_ops_and_rotation():
    ctx = _context(_params(pytroy.SchemeType.bfv))
    be = pytroy.BatchEncoder(ctx)
    kg = pytroy.KeyGenerator(ctx)
    rlk, gk = kg.create_relin_keys(), kg.create_galois_keys()
    enc = pytroy.Encryptor(ctx, kg.create_public_key(), kg.secret_key())
    dec = pytroy.Decryptor(ctx, kg.secret_key())
    ev = pytroy.Evaluator(ctx)
    t = 1 << 16
    a = np.arange(N, dtype=np.uint64) % 97
    b = (np.arange(N, dtype=np.uint64) * 3 + 1) % 97
    c1 = enc.encrypt_symmetric(be.encode(a))
    ev.multiply_inplace(c1, enc.encrypt(be.encode(b)))
    ev.relinearize_inplace(c1, rlk)
    np.testing.assert_array_equal(be.decode(dec.decrypt(c1)), a * b % t)
    ct = enc.encrypt(be.encode(a))
    ev.rotate_rows_inplace(ct, 1, gk)
    half = N // 2
    np.testing.assert_array_equal(
        be.decode(dec.decrypt(ct)),
        np.concatenate([np.roll(a[:half], -1), np.roll(a[half:], -1)]))
    assert dec.invariant_noise_budget(enc.encrypt(be.encode(a))) > 0


def test_matmul_helper_protocol():
    ctx = _context(_params(pytroy.SchemeType.bfv))
    be = pytroy.BatchEncoder(ctx)
    kg = pytroy.KeyGenerator(ctx)
    enc = pytroy.Encryptor(ctx, kg.create_public_key(), kg.secret_key())
    dec = pytroy.Decryptor(ctx, kg.secret_key())
    ev = pytroy.Evaluator(ctx)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 50, (2, 3), dtype=np.uint64)
    w = rng.integers(0, 50, (3, 4), dtype=np.uint64)
    helper = pytroy.MatmulHelper(2, 3, 4, N, objective=0, pack_lwe=False)
    y_ct = helper.matmul(ev, helper.encrypt_inputs(enc, be, x),
                         helper.encode_weights(be, w))
    y_back = helper.deserialize_outputs(ev, helper.serialize_outputs(ev,
                                                                     y_ct))
    np.testing.assert_array_equal(helper.decrypt_outputs(be, dec, y_back),
                                  (x @ w) % (1 << 16))


def test_binder_container_surface():
    assert pytroy.Modulus(65537).is_prime()
    assert not pytroy.Modulus(65536).is_prime()
    ctx = _context(_params(pytroy.SchemeType.bfv))
    kg = pytroy.KeyGenerator(ctx)
    enc = pytroy.BatchEncoder(ctx)
    encryptor = pytroy.Encryptor(ctx)
    encryptor.set_secret_key(kg.secret_key())
    decryptor = pytroy.Decryptor(ctx, kg.secret_key())
    ev = pytroy.Evaluator(ctx)
    ct = encryptor.encrypt_symmetric(
        enc.encode_polynomial(np.arange(4, dtype=np.uint64)))
    assert ct.parms_id() == ctx.first_parms_id()
    ct.resize(3)
    assert ct.size() == 3
    ct.resize(2)
    ct.reserve(8)
    assert list(enc.decode_polynomial(decryptor.decrypt(ct))[:4]) == \
        [0, 1, 2, 3]
    outs = ev.multiply_batch(
        [ct], [enc.encode_polynomial(np.array([7], dtype=np.uint64))])
    assert list(enc.decode_polynomial(decryptor.decrypt(outs[0]))[:4]) == \
        [0, 7, 14, 21]
    # copy() shares the immutable inner object; an in-place op swaps it
    twin = ct.copy()
    ev.negate_inplace(twin)
    assert list(enc.decode_polynomial(decryptor.decrypt(ct))[:4]) == \
        [0, 1, 2, 3]
    p = enc.encode_polynomial(np.array([1, 2], dtype=np.uint64))
    assert p.to_string() == "2x^1 + 1"
    p.set_zero()
    assert p.to_string() == "0"


def test_matmul_mask_and_weight_serialization():
    t = 1 << 16
    ctx = _context(_params(pytroy.SchemeType.bfv, t=t))
    kg = pytroy.KeyGenerator(ctx)
    enc = pytroy.BatchEncoder(ctx)
    encryptor = pytroy.Encryptor(ctx, kg.secret_key())
    decryptor = pytroy.Decryptor(ctx, kg.secret_key())
    ev = pytroy.Evaluator(ctx)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 50, (3, 4)).astype(np.uint64)
    w = rng.integers(0, 50, (4, 5)).astype(np.uint64)
    mask = rng.integers(0, 1000, (3, 5)).astype(np.uint64)
    want = (x.astype(object) @ w.astype(object) + mask) % t
    for pack in (False, True):
        helper = pytroy.MatmulHelper(3, 4, 5, N, objective=0, pack_lwe=pack)
        we = helper.deserialize_encoded_weights(
            helper.serialize_encoded_weights(helper.encode_weights(enc, w)))
        y = helper.matmul(ev, helper.encrypt_inputs(encryptor, enc, x), we)
        if pack:
            y = helper.pack_outputs(ev, kg.create_automorphism_keys(), y)
        y.add_plain_inplace(ev, helper.encode_outputs(enc, mask))
        got = helper.decrypt_outputs(enc, decryptor, y)
        assert (got.astype(np.uint64) == want.astype(np.uint64)).all()


def test_cipher2d_scalar_and_switch_key():
    ctx = _context(_params(pytroy.SchemeType.bfv, t=1 << 16))
    kg = pytroy.KeyGenerator(ctx)
    enc = pytroy.BatchEncoder(ctx)
    encryptor = pytroy.Encryptor(ctx, kg.secret_key())
    ev = pytroy.Evaluator(ctx)
    helper = pytroy.MatmulHelper(2, 3, 2, N, objective=0, pack_lwe=False)
    c = helper.encrypt_inputs(encryptor, enc,
                              np.arange(6, dtype=np.uint64).reshape(2, 3))
    c.multiply_scalar_inplace(enc, ev, 5)
    # the generator holds the target key, the argument is the source key
    # (troy's test/evaluator_cuda.cu:2553)
    kg2 = pytroy.KeyGenerator(ctx)
    c.switch_key(ev, kg2.create_keyswitching_keys(kg.secret_key()))
    dec2 = pytroy.Decryptor(ctx, kg2.secret_key())
    got = enc.decode_polynomial(dec2.decrypt(
        pytroy.Ciphertext(c._inner.data[0][0])))
    assert list(got[:3]) == [0, 5, 10]


def test_bfv_two_party_seeded_symmetric_protocol():
    ctx_a = _context(_params(pytroy.SchemeType.bfv))
    be_a = pytroy.BatchEncoder(ctx_a)
    kg = pytroy.KeyGenerator(ctx_a)
    rlk_bytes = kg.create_relin_keys().save()
    enc = pytroy.Encryptor(ctx_a, kg.create_public_key(), kg.secret_key())
    dec = pytroy.Decryptor(ctx_a, kg.secret_key())
    a = np.arange(N, dtype=np.uint64) % 251
    b = (np.arange(N, dtype=np.uint64) * 7 + 1) % 251
    blob_a = enc.encrypt_symmetric(be_a.encode(a), save_seed=True).save()
    full = enc.encrypt_symmetric(be_a.encode(a), save_seed=False).save()
    assert len(blob_a) < len(full)
    ctx_b = _context(_params(pytroy.SchemeType.bfv))
    be_b = pytroy.BatchEncoder(ctx_b)
    rlk_b = pytroy.RelinKeys()
    rlk_b.load(rlk_bytes)
    ev_b = pytroy.Evaluator(ctx_b)
    c = pytroy.Ciphertext()
    c.load(blob_a, ctx_b)
    ev_b.multiply_plain_inplace(c, be_b.encode(b))
    c_back = pytroy.Ciphertext()
    c_back.load(c.save(), ctx_a)
    np.testing.assert_array_equal(be_a.decode(dec.decrypt(c_back)),
                                  a * b % (1 << 16))


def test_bgv_compat_roundtrip():
    ctx = _context(_params(pytroy.SchemeType.bgv))
    be = pytroy.BatchEncoder(ctx)
    kg = pytroy.KeyGenerator(ctx)
    rlk = kg.create_relin_keys()
    enc = pytroy.Encryptor(ctx, kg.create_public_key(), kg.secret_key())
    dec = pytroy.Decryptor(ctx, kg.secret_key())
    ev = pytroy.Evaluator(ctx)
    a = np.arange(N, dtype=np.uint64) % 199
    b = (np.arange(N, dtype=np.uint64) * 5 + 2) % 199
    c1 = enc.encrypt(be.encode(a))
    ev.multiply_inplace(c1, enc.encrypt(be.encode(b)))
    ev.relinearize_inplace(c1, rlk)
    ev.mod_switch_to_next_inplace(c1)
    c3 = pytroy.Ciphertext()
    c3.load(c1.save(), ctx)
    assert c3.correction_factor() == c1.correction_factor()
    np.testing.assert_array_equal(be.decode(dec.decrypt(c3)),
                                  a * b % (1 << 16))


def test_binder_metadata_surface():
    pytroy.Smoke()
    pytroy.Smoke(3)
    parms = _params(pytroy.SchemeType.bfv)
    ctx = _context(parms)
    pid = parms.parms_id()
    assert isinstance(pid, bytes) and len(pid) == 32
    assert len(pid.vec()) == 4 and pid == ctx.key_parms_id()
    assert ctx.first_parms_id().vec() != pid.vec()
    assert ctx.key_context_data().parms().parms_id() == pid
    fcd = ctx.first_context_data()
    assert len(fcd.parms().coeff_modulus()) == 2
    assert fcd.parms().parms_id() == ctx.first_parms_id()
    assert fcd.chain_index() == 1 and ctx.last_context_data().chain_index() \
        == 0
    assert fcd.prev_context_data().parms_id() == pid
    assert ctx.key_context_data().prev_context_data() is None
    assert ctx.get_context_data(ctx.last_parms_id()).next_context_data() \
        is None
    assert ctx.using_keyswitching()


def test_extension_methods_beyond_binder():
    ctx = _context(_params(pytroy.SchemeType.bfv))
    kg = pytroy.KeyGenerator(ctx)
    encryptor = pytroy.Encryptor(ctx, kg.create_public_key())
    encryptor.set_secret_key(kg.secret_key())
    decryptor = pytroy.Decryptor(ctx, kg.secret_key())
    encoder = pytroy.BatchEncoder(ctx)
    ev = pytroy.Evaluator(ctx)
    gk = kg.create_galois_keys([1, 2])
    vals = np.arange(N, dtype=np.uint64)
    ct = encryptor.encrypt(encoder.encode_polynomial(vals))
    for term, lwe in zip([0, 3, 9], ev.extract_lwe_many(ct, [0, 3, 9])):
        out = encoder.decode_polynomial(decryptor.decrypt(
            ev.assemble_lwe(lwe)))
        assert int(out[0]) == int(vals[term])
    lwe = ev.extract_lwe(ct, 5)
    assert int(encoder.decode_polynomial(decryptor.decrypt(
        ev.assemble_lwe(lwe)))[0]) == 5
    ct2 = encryptor.encrypt(encoder.encode(vals))
    half = N // 2
    for s, o in zip([1, 2], ev.rotate_many(ct2, [1, 2], gk)):
        want = np.concatenate([np.roll(vals[:half], -s),
                               np.roll(vals[half:], -s)])
        np.testing.assert_array_equal(encoder.decode(decryptor.decrypt(o)),
                                      want)
    ev.divide_by_poly_modulus_degree_inplace(ct, N)
    np.testing.assert_array_equal(
        encoder.decode_polynomial(decryptor.decrypt(ct)), vals)


# ---------------------------------------------------------------------------
# tests/test_binder_parity.py: troy's binder/test.py and binder/timetest.py
# ---------------------------------------------------------------------------

PARITY_N = 4096


class Alice:
    """binder/test.py:9-78 (prints -> asserts), at n = 4096."""

    def __init__(self):
        self.context = _context(_params(pytroy.SchemeType.ckks, PARITY_N,
                                        [40] * 6))
        self.encoder = pytroy.CKKSEncoder(self.context)
        self.keygen = pytroy.KeyGenerator(self.context)
        self.public_key = self.keygen.create_public_key()
        self.encryptor = pytroy.Encryptor(self.context, self.public_key)
        self.decryptor = pytroy.Decryptor(self.context,
                                          self.keygen.secret_key())
        self.evaluator = pytroy.Evaluator(self.context)

    def get_public_key(self):
        relin_keys = self.keygen.create_relin_keys()
        galois_keys = self.keygen.create_galois_keys()
        relin_keys.load(relin_keys.save())
        self.relin_keys = relin_keys
        return (self.public_key.save(), relin_keys.save(),
                galois_keys.save())

    def get_ciphers(self):
        p1, p2 = pytroy.Plaintext(), pytroy.Plaintext()
        self.encoder.encode([1, 2, 3, 4], 1 << 40, p1)
        self.encoder.encode([0.5, 0.6, 0.7, 0.8], 1 << 40, p2)
        c1, c2 = pytroy.Ciphertext(), pytroy.Ciphertext()
        self.encryptor.encrypt(p1, c1)
        self.encryptor.encrypt(p2, c2)
        ret = (c1.save(), c2.save())
        self.evaluator.multiply_inplace(c1, c2)
        self.evaluator.relinearize_inplace(c1, self.relin_keys)
        np.testing.assert_allclose(np.real(self.decrypt(c1.save())[:4]),
                                   [0.5, 1.2, 2.1, 3.2], atol=1e-3)
        return ret

    def decrypt(self, c_s):
        c = pytroy.Ciphertext()
        c.load(c_s)
        p = pytroy.Plaintext()
        self.decryptor.decrypt(c, p)
        return self.encoder.decode(p)


class Bob:
    def __init__(self):
        self.context = _context(_params(pytroy.SchemeType.ckks, PARITY_N,
                                        [40] * 6))

    def receive_public_key(self, keys):
        s_public_key, s_relin_keys, s_galois_keys = keys
        self.public_key = pytroy.PublicKey()
        self.public_key.load(s_public_key)
        self.encryptor = pytroy.Encryptor(self.context, self.public_key)
        self.evaluator = pytroy.Evaluator(self.context)
        self.relin_keys = pytroy.RelinKeys()
        self.relin_keys.load(s_relin_keys)
        self.galois_keys = pytroy.GaloisKeys()
        self.galois_keys.load(s_galois_keys)

    def evaluate(self, c1_s, c2_s):
        c1, c2 = pytroy.Ciphertext(), pytroy.Ciphertext()
        c1.load(c1_s)
        c2.load(c2_s)
        self.evaluator.multiply_inplace(c1, c2)
        self.evaluator.relinearize_inplace(c1, self.relin_keys)
        self.evaluator.rescale_to_next_inplace(c1)
        return c1.save()


def test_two_party_protocol():
    alice = Alice()
    keys = alice.get_public_key()
    bob = Bob()
    bob.receive_public_key(keys)
    c3_s = bob.evaluate(*alice.get_ciphers())
    np.testing.assert_allclose(np.real(alice.decrypt(c3_s)[:4]),
                               [0.5, 1.2, 2.1, 3.2], atol=1e-3)


class _OpSurface:
    """binder/timetest.py TimeTest (:53-148), repeat = 2, no timing."""

    def run_add(self, repeat=2):
        c1, c2 = self.random_ciphertext(), self.random_ciphertext()
        c3 = pytroy.Ciphertext()
        for _ in range(repeat):
            self.evaluator.add(c1, c2, c3)
            self.evaluator.add_inplace(c3, c1)
            c4 = self.evaluator.add(c1, c3)
        return c4

    def run_add_plain(self, repeat=2):
        c1, p2 = self.random_ciphertext(), self.random_plaintext()
        c3 = pytroy.Ciphertext()
        for _ in range(repeat):
            self.evaluator.add_plain(c1, p2, c3)
            self.evaluator.add_plain_inplace(c3, p2)
            c4 = self.evaluator.add_plain(c3, p2)
        assert c4.size() == 2

    def run_multiply_plain(self, repeat=2):
        c1, p2 = self.random_ciphertext(), self.random_plaintext()
        c3 = pytroy.Ciphertext()
        for _ in range(repeat):
            self.evaluator.multiply_plain(c1, p2, c3)
            self.evaluator.multiply_plain_inplace(c3, p2)
            c4 = self.evaluator.multiply_plain(c1, p2)
        assert c4.size() == 2

    def run_square(self, repeat=2):
        c1 = self.random_ciphertext()
        c2 = pytroy.Ciphertext()
        for _ in range(repeat):
            self.evaluator.square(c1, c2)
            c3 = c1.copy()
            self.evaluator.square_inplace(c3)
            c4 = self.evaluator.square(c1)
        assert c2.size() == 3 and c3.size() == 3 and c4.size() == 3

    def run_memory_pool(self, repeat=2):
        c1 = self.random_ciphertext()
        for _ in range(repeat):
            c3 = pytroy.Ciphertext()
            self.evaluator.square(c1, c3)
        assert c3.size() == 3


class _CKKSSurface(_OpSurface):
    """binder/timetest.py TimeTestCKKS (:153-258)."""

    def __init__(self, n, qs, delta, seed):
        self.rng = random.Random(seed)
        self.slots, self.bound, self.delta = n // 2, 1 << 6, delta
        context = _context(_params(pytroy.SchemeType.ckks, n, qs))
        keygen = pytroy.KeyGenerator(context)
        self.pk, self.rlk, self.gk = (pytroy.PublicKey(), pytroy.RelinKeys(),
                                      pytroy.GaloisKeys())
        keygen.create_public_key(self.pk)
        keygen.create_relin_keys(self.rlk)
        keygen.create_galois_keys(self.gk)
        self.encoder = pytroy.CKKSEncoder(context)
        self.encryptor = pytroy.Encryptor(context, self.pk)
        self.decryptor = pytroy.Decryptor(context, keygen.secret_key())
        self.evaluator = pytroy.Evaluator(context)

    def random_vector(self, count):
        return [self.rng.random() * self.bound * 2 - self.bound
                for _ in range(count)]

    def random_plaintext(self, values=None):
        ret = pytroy.Plaintext()
        self.encoder.encode(values or self.random_vector(self.slots),
                            self.delta, ret)
        return ret

    def random_ciphertext(self, values=None):
        ret = pytroy.Ciphertext()
        self.encryptor.encrypt(self.random_plaintext(values), ret)
        return ret

    def decode(self, c):
        return self.encoder.decode(self.decryptor.decrypt(c))

    def run_multiply_rescale(self, repeat=2):
        c1, c2 = self.random_ciphertext(), self.random_ciphertext()
        c3, c4 = pytroy.Ciphertext(), pytroy.Ciphertext()
        for _ in range(repeat):
            self.evaluator.multiply(c1, c2, c3)
            self.evaluator.rescale_to_next(c3, c4)
            c5 = c1.copy()
            self.evaluator.multiply_inplace(c5, c2)
            self.evaluator.rescale_to_next_inplace(c5)
        assert c4.size() == 3 and c5.size() == 3

    def run_rotate_vector(self, repeat=2):
        c1 = self.random_ciphertext()
        c2 = pytroy.Ciphertext()
        for _ in range(repeat):
            self.evaluator.rotate_vector(c1, 1, self.gk, c2)
            self.evaluator.rotate_vector_inplace(c1, 1, self.gk)
        assert c2.size() == 2


class _BFVBGVSurface(_OpSurface):
    """binder/timetest.py TimeTestBFVBGV (:260-372): a power-of-two plain
    modulus (no batching) and encode_polynomial."""

    def __init__(self, bgv, n, t_bits, qs, seed):
        self.rng = random.Random(seed)
        self.slots, self.bound = n, 1 << 6
        scheme = pytroy.SchemeType.bgv if bgv else pytroy.SchemeType.bfv
        context = _context(_params(scheme, n, qs, t=1 << t_bits))
        keygen = pytroy.KeyGenerator(context)
        self.pk, self.rlk = pytroy.PublicKey(), pytroy.RelinKeys()
        keygen.create_public_key(self.pk)
        keygen.create_relin_keys(self.rlk)
        self.encoder = pytroy.BatchEncoder(context)
        self.encryptor = pytroy.Encryptor(context, self.pk)
        self.decryptor = pytroy.Decryptor(context, keygen.secret_key())
        self.evaluator = pytroy.Evaluator(context)

    def random_vector(self, count):
        return [int(self.rng.random() * self.bound) % self.bound
                for _ in range(count)]

    def random_plaintext(self, values=None):
        return self.encoder.encode_polynomial(
            values or self.random_vector(self.slots))

    def random_ciphertext(self, values=None):
        ret = pytroy.Ciphertext()
        self.encryptor.encrypt(self.random_plaintext(values), ret)
        return ret

    def decode(self, c):
        return self.encoder.decode_polynomial(self.decryptor.decrypt(c))

    def run_multiply_modswitch(self, repeat=2):
        c1, c2 = self.random_ciphertext(), self.random_ciphertext()
        c3, c4 = pytroy.Ciphertext(), pytroy.Ciphertext()
        for _ in range(repeat):
            self.evaluator.multiply(c1, c2, c3)
            self.evaluator.mod_switch_to_next(c3, c4)
            c5 = c1.copy()
            self.evaluator.multiply_inplace(c5, c2)
            self.evaluator.mod_switch_to_next_inplace(c5)
        assert c4.size() == 3 and c5.size() == 3


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_timetest_op_surface_bfv_bgv(scheme):
    s = _BFVBGVSurface(scheme == "bgv", PARITY_N, 41, (60, 50, 60),
                       seed=7 if scheme == "bfv" else 13)
    v1, v2 = s.random_vector(s.slots), s.random_vector(s.slots)
    c4 = s.run_add()
    s.run_add_plain()
    s.run_multiply_modswitch()
    s.run_multiply_plain()
    s.run_square()
    s.run_memory_pool()
    assert c4.size() == 2
    np.testing.assert_array_equal(
        s.decode(s.random_ciphertext(v1)).astype(np.int64)[:len(v1)], v1)
    # every result decrypts right: (v1 + v2) + v1 + v2 and v1 v2 mod t
    t, c1, c2 = 1 << 41, s.random_ciphertext(v1), s.random_ciphertext(v2)
    a, b = np.array(v1, dtype=object), np.array(v2, dtype=object)
    np.testing.assert_array_equal(
        s.decode(s.evaluator.add(c1, c2)).astype(object), (a + b) % t)
    prod = s.evaluator.relinearize(s.evaluator.multiply(c1, c2), s.rlk)
    negacyclic = np.zeros(s.slots, dtype=object)
    for i in range(s.slots):          # a b mod x^n + 1, at the degrees
        negacyclic[i:] += a[i] * b[:s.slots - i]
        negacyclic[:i] -= a[i] * b[s.slots - i:]
    np.testing.assert_array_equal(
        s.decode(s.evaluator.mod_switch_to_next(prod)).astype(object),
        negacyclic % t)


def test_timetest_op_surface_ckks():
    s = _CKKSSurface(PARITY_N, (60, 40, 40, 60), 1 << 40, seed=11)
    s.run_add()
    s.run_add_plain()
    s.run_multiply_rescale()
    s.run_multiply_plain()
    s.run_square()
    s.run_rotate_vector()
    s.run_memory_pool()
    v = s.random_vector(8)
    np.testing.assert_allclose(np.real(s.decode(s.random_ciphertext(v))[:8]),
                               v, atol=1e-3)
    w = s.random_vector(8)
    c = s.evaluator.rescale_to_next(s.evaluator.relinearize(
        s.evaluator.multiply(s.random_ciphertext(v), s.random_ciphertext(w)),
        s.rlk))
    np.testing.assert_allclose(np.real(s.decode(c)[:8]),
                               np.array(v) * np.array(w), atol=1e-3)
    r = s.evaluator.rotate_vector(s.random_ciphertext(v), 1, s.gk)
    np.testing.assert_allclose(np.real(s.decode(r)[:7]), v[1:], atol=1e-3)


# ---------------------------------------------------------------------------
# troy's wire through the shim, and the JAX package's shim's bytes
# ---------------------------------------------------------------------------

def _records():
    with open(DATA, "rb") as f:
        raw = f.read()
    recs, off = {}, 0
    while off < len(raw):
        nl = raw.index(b"\n", off)
        name, nbytes = raw[off:nl].decode().rsplit(" ", 1)
        recs[name] = raw[nl + 1:nl + 1 + int(nbytes)]
        off = nl + 1 + int(nbytes)
    return recs


def test_compat_shim_speaks_troy_wire():
    recs = _records()
    ctx = _context(_params(pytroy.SchemeType.bfv,
                           t=pytroy.PlainModulus.batching(N, 17)))
    ct = pytroy.Ciphertext()
    ct.load(recs["bfv_ct"], ctx)
    assert ct.save(ctx, wire="troy") == recs["bfv_ct"]
    native_bytes = ct.save()
    assert native_bytes[:4] == b"TCT1"
    ct2 = pytroy.Ciphertext()
    ct2.load(native_bytes)
    assert ct2.save(ctx, wire="troy") == recs["bfv_ct"]
    sk, gk, rlk, pk = (pytroy.SecretKey(), pytroy.GaloisKeys(),
                       pytroy.RelinKeys(), pytroy.PublicKey())
    for obj, name in ((sk, "bfv_sk"), (gk, "bfv_gk"), (rlk, "bfv_rlk"),
                      (pk, "bfv_pk")):
        obj.load(recs[name], ctx)
        assert obj.save(ctx, wire="troy") == recs[name]
    pt = pytroy.Plaintext()
    pt.load(recs["bfv_pt"], ctx)
    assert pt.save(ctx, wire="troy") == recs["bfv_pt"]
    out = pytroy.Plaintext()
    pytroy.Decryptor(ctx, sk).decrypt(ct, out)
    np.testing.assert_array_equal(
        pytroy.BatchEncoder(ctx).decode(out)[:N],
        np.arange(N, dtype=np.uint64) % 97)
    for obj in (ct, sk, gk, out):
        with pytest.raises(ValueError, match="needs a context"):
            obj.save(wire="troy")
    with pytest.raises(ValueError, match="needs a context"):
        pytroy.Ciphertext().load(recs["bfv_ct"])


def _shim_run(mod):
    """Seeded keys and a seeded product through one shim: the bytes of
    every key in both wires."""
    parms = _params(mod.SchemeType.bfv, mod=mod)
    ctx = (_context(parms) if mod is pytroy else
           mod.SEALContext(parms, True, mod.SecurityLevel.none))
    seed = bytes(range(64))
    kg = mod.KeyGenerator(ctx, seed)
    keys = [kg.secret_key(), kg.create_public_key(), kg.create_relin_keys(),
            kg.create_galois_keys([1])]
    return ctx, kg, {"native": [k.save() for k in keys],
                     "troy": [k.save(ctx, wire="troy") for k in keys]}


def test_seeded_keys_byte_equal_to_the_jax_shim():
    jctx, jkg, jbytes = _shim_run(jpytroy)
    ctx, kg, pbytes = _shim_run(pytroy)
    assert pbytes == jbytes


def test_jax_shim_ciphertext_through_both_shims():
    """A ciphertext saved by pytroy, loaded in both shims with the same
    seeded relin key, multiplied and relinearized: equal bytes in both
    wires."""
    jctx, jkg, _ = _shim_run(jpytroy)
    be = jpytroy.BatchEncoder(jctx)
    enc = jpytroy.Encryptor(jctx, jkg.secret_key())
    vals = np.arange(N, dtype=np.uint64) % 251
    raw = enc.encrypt_symmetric(be.encode(vals)).save()
    ctx, kg, _ = _shim_run(pytroy)
    out = {}
    for mod, c, g in ((jpytroy, jctx, jkg), (pytroy, ctx, kg)):
        ct = mod.Ciphertext()
        ct.load(raw, c)
        ev = mod.Evaluator(c)
        ev.multiply_inplace(ct, ct.copy())
        ev.relinearize_inplace(ct, g.create_relin_keys())
        out[mod] = (ct.save(), ct.save(c, wire="troy"))
    assert out[pytroy] == out[jpytroy]
    dec = pytroy.Decryptor(ctx, kg.secret_key())
    back = pytroy.Ciphertext()
    back.load(out[jpytroy][1], ctx)
    np.testing.assert_array_equal(
        pytroy.BatchEncoder(ctx).decode(dec.decrypt(back)),
        vals * vals % int(pytroy.PlainModulus.batching(N, 16)))
