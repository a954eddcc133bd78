"""troy_tpu_torch/refwire.py, troy's raw-struct wire, on the CPU.

``tests/data/ref_wire_n64.bin`` holds streams in the layout of troy's CUDA
classes' save(), written by troy's CPU library (generator:
ref_wire_n64_generator.cpp.txt). Both directions, as tests/test_refwire.py
holds troy_tpu to them: every record loads into the port and decrypts or
operates bit-exactly, load -> save reproduces every record's bytes, and
the port's seeded secret key saves to troy's bytes. Then the port against
troy_tpu/refwire.py: the same objects give the same bytes, and each
package loads the other's.
"""

import os

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng
from troy_tpu import refwire as jrw

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng
from troy_tpu_torch import refwire as rw

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data", "ref_wire_n64.bin")
N = 64
VALUES = np.arange(N, dtype=np.uint64) % 97
RECORDS = {"bfv_ct": "ciphertext", "bfv_pt": "plaintext",
           "bfv_sk": "secret_key", "bfv_pk": "public_key",
           "bfv_rlk": "relin_keys", "bfv_gk": "galois_keys",
           "ckks_ct": "ciphertext", "ckks_pt": "plaintext",
           "ckks_sk": "secret_key"}


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


def _ctx(mod, scheme):
    if scheme == "bfv":
        parms = mod.EncryptionParameters(
            scheme=mod.SchemeType.bfv, poly_modulus_degree=N,
            coeff_modulus=tuple(mod.CoeffModulus.create(N, [40, 40, 40])),
            plain_modulus=mod.PlainModulus.batching(N, 17))
    else:
        parms = mod.EncryptionParameters(
            scheme=mod.SchemeType.ckks, poly_modulus_degree=N,
            coeff_modulus=tuple(mod.CoeffModulus.create(N, [50, 30, 50])))
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)


@pytest.fixture(scope="module")
def recs():
    return _records()


@pytest.fixture(scope="module")
def ctxs():
    return {s: _ctx(P, s) for s in ("bfv", "ckks")}


def test_ref_parms_id_matches_troy_tpu(ctxs):
    jctx = _ctx(J, "bfv")
    ids = [rw.ref_parms_id(cd.parms) for cd in ctxs["bfv"].chain]
    assert ids == [jrw.ref_parms_id(cd.parms) for cd in jctx.chain]
    assert len(set(ids)) == len(ids)
    assert all(len(i) == 32 and i != rw.REF_PARMS_ID_ZERO for i in ids)


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_load_save_reproduces_every_record(recs, ctxs, name):
    ctx = ctxs[name.split("_")[0]]
    kind = RECORDS[name]
    obj = getattr(rw, f"load_{kind}_ref")(recs[name], ctx)
    assert getattr(rw, f"save_{kind}_ref")(obj, ctx) == recs[name]
    # troy_tpu loads the same record to the same words
    jctx = _ctx(J, name.split("_")[0])
    jobj = getattr(jrw, f"load_{kind}_ref")(recs[name], jctx)
    if kind.endswith("keys"):
        assert sorted(obj.keys) == sorted(jobj.keys)
        for k in obj.keys:
            np.testing.assert_array_equal(interop.to_numpy(obj.keys[k]),
                                          np.asarray(jobj.keys[k]))
    else:
        np.testing.assert_array_equal(interop.to_numpy(obj.data),
                                      np.asarray(jobj.data))


def test_seeded_secret_key_saves_to_troys_bytes(recs, ctxs):
    ctx = ctxs["bfv"]
    kg = P.KeyGenerator(ctx, seed=tprng.seed_from_uint64(42))
    sk = rw.load_secret_key_ref(recs["bfv_sk"], ctx)
    assert torch.equal(sk.data, kg.secret_key.data)
    assert rw.save_secret_key_ref(kg.secret_key, ctx) == recs["bfv_sk"]


def test_troys_ciphertext_and_plaintext_decrypt(recs, ctxs):
    ctx = ctxs["bfv"]
    sk = rw.load_secret_key_ref(recs["bfv_sk"], ctx)
    ct = rw.load_ciphertext_ref(recs["bfv_ct"], ctx)
    assert not ct.is_ntt_form and ct.size == 2
    be = P.BatchEncoder(ctx)
    np.testing.assert_array_equal(
        be.decode(P.Decryptor(ctx, sk).decrypt(ct)), VALUES)
    pt = rw.load_plaintext_ref(recs["bfv_pt"], ctx)
    assert not pt.is_ntt_form and pt.level is None
    np.testing.assert_array_equal(be.decode(pt), VALUES)


def test_troys_keys_operate(recs, ctxs):
    """Keys from troy's bytes relinearize and rotate ciphertexts the port
    encrypted."""
    ctx = ctxs["bfv"]
    sk = rw.load_secret_key_ref(recs["bfv_sk"], ctx)
    rlk = rw.load_relin_keys_ref(recs["bfv_rlk"], ctx)
    gk = rw.load_galois_keys_ref(recs["bfv_gk"], ctx)
    assert sorted(rlk.keys) == [2] and sorted(gk.keys) == [3, 127]
    t = int(ctx.key_context_data.plain_modulus)
    enc = P.Encryptor(ctx, secret_key=sk, seed=tprng.seed_from_uint64(9))
    be, ev = P.BatchEncoder(ctx), P.Evaluator(ctx)
    dec = P.Decryptor(ctx, sk)
    b = (VALUES * 3 + 1) % t
    prod = ev.relinearize(ev.multiply(enc.encrypt_symmetric(be.encode(VALUES)),
                                      enc.encrypt_symmetric(be.encode(b))),
                          rlk)
    model = (VALUES.astype(object) * b.astype(object) % t).astype(np.uint64)
    np.testing.assert_array_equal(be.decode(dec.decrypt(prod)), model)
    rot = ev.apply_galois(prod, 3, gk)            # step 1 at n = 64
    half = N // 2
    want = np.concatenate([np.roll(model[:half], -1),
                           np.roll(model[half:], -1)])
    np.testing.assert_array_equal(be.decode(dec.decrypt(rot)), want)


def test_terms_stream(recs, ctxs):
    ctx = ctxs["bfv"]
    ids = [0, 3, 17, 40]
    full = rw.load_ciphertext_ref(recs["bfv_ct"], ctx)
    part = rw.load_terms_ref(recs["bfv_ct_terms"], ctx, ids)
    assert part.size == full.size
    fd, pd = interop.to_numpy(full.data), interop.to_numpy(part.data)
    np.testing.assert_array_equal(pd[0][:, ids], fd[0][:, ids])
    np.testing.assert_array_equal(pd[1], fd[1])
    assert rw.save_terms_ref(full, ctx, ids) == recs["bfv_ct_terms"]
    dec = P.Decryptor(ctx, rw.load_secret_key_ref(recs["bfv_sk"], ctx))
    want = interop.to_numpy(dec.decrypt(full).data)
    got = interop.to_numpy(dec.decrypt(part).data)
    np.testing.assert_array_equal(got[ids], want[ids])


def test_ntt_form_terms_round_trip(ctxs):
    """saveTerms of an NTT-form CKKS ciphertext leaves NTT form (A) and
    loadTerms returns to it: the saved terms and c1 come back."""
    ctx = ctxs["ckks"]
    kg = P.KeyGenerator(ctx, seed=tprng.seed_from_uint64(3))
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=tprng.seed_from_uint64(4))
    ct = enc.encrypt_symmetric(P.CKKSEncoder(ctx).encode(
        np.linspace(-1, 1, N // 2), 2.0 ** 30))
    ids = [1, 5, 9]
    back = rw.load_terms_ref(rw.save_terms_ref(ct, ctx, ids), ctx, ids)
    assert back.is_ntt_form
    assert torch.equal(back.data[1], ct.data[1])
    ev = P.Evaluator(ctx)
    a = ev.transform_from_ntt(ct).data[0][:, ids]
    b = ev.transform_from_ntt(back).data[0][:, ids]
    assert torch.equal(a, b)


def test_ckks_reference_ciphertext_decodes(recs, ctxs):
    ctx = ctxs["ckks"]
    sk = rw.load_secret_key_ref(recs["ckks_sk"], ctx)
    ct = rw.load_ciphertext_ref(recs["ckks_ct"], ctx)
    assert ct.is_ntt_form and ct.scale == 2.0 ** 30
    pt = rw.load_plaintext_ref(recs["ckks_pt"], ctx)
    assert pt.is_ntt_form and pt.level == ct.level
    ce = P.CKKSEncoder(ctx)
    want = 0.25 * (np.arange(N // 2) % 9)
    np.testing.assert_allclose(np.real(ce.decode(pt)), want, atol=1e-5)
    np.testing.assert_allclose(
        np.real(ce.decode(P.Decryptor(ctx, sk).decrypt(ct))), want,
        atol=1e-4)


def test_seeded_keys_and_ciphertexts_byte_equal_to_troy_tpu(ctxs):
    """The same seeds in both packages: every key and a seed-compressed
    ciphertext (expanded on save by each package's threefry draw) save to
    the same bytes, and each package loads the other's."""
    ctx, jctx = ctxs["bfv"], _ctx(J, "bfv")
    out = {}
    for mod, prng, c in ((P, tprng, ctx), (J, jprng, jctx)):
        kg = mod.KeyGenerator(c, seed=prng.seed_from_uint64(77))
        enc = mod.Encryptor(c, secret_key=kg.secret_key,
                            seed=prng.seed_from_uint64(78))
        ct = enc.encrypt_symmetric(mod.BatchEncoder(c).encode(VALUES),
                                   save_seed=True)
        assert ct.seed != 0
        lib = rw if mod is P else jrw
        out[mod] = [lib.save_secret_key_ref(kg.secret_key, c),
                    lib.save_public_key_ref(kg.create_public_key(), c),
                    lib.save_relin_keys_ref(kg.create_relin_keys(), c),
                    lib.save_galois_keys_ref(
                        kg.create_galois_keys(steps=[1, 0]), c),
                    lib.save_ciphertext_ref(ct, c)]
    assert out[P] == out[J]
    ct_raw = out[J][4]
    assert rw.save_ciphertext_ref(rw.load_ciphertext_ref(ct_raw, ctx),
                                  ctx) == ct_raw
    assert jrw.save_ciphertext_ref(jrw.load_ciphertext_ref(out[P][4], jctx),
                                   jctx) == out[P][4]
    dec = P.Decryptor(ctx, rw.load_secret_key_ref(out[J][0], ctx))
    np.testing.assert_array_equal(
        P.BatchEncoder(ctx).decode(dec.decrypt(
            rw.load_ciphertext_ref(ct_raw, ctx))), VALUES)


def test_loads_refuse_what_troy_refuses(recs, ctxs):
    ctx = ctxs["bfv"]
    with pytest.raises(ValueError, match="saveTerms"):
        rw.load_ciphertext_ref(recs["bfv_ct_terms"], ctx)
    with pytest.raises(ValueError, match="not saved with saveTerms"):
        rw.load_terms_ref(recs["bfv_ct"], ctx, [0])
    with pytest.raises(ValueError, match="matches no chain level"):
        rw.load_ciphertext_ref(recs["ckks_ct"], ctx)
    with pytest.raises(ValueError, match="key level"):
        rw.load_relin_keys_ref(recs["bfv_rlk"], ctxs["ckks"])
