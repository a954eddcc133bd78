"""troy_tpu_torch stands alone: it imports no JAX, and it never hides a
missing card behind the CPU."""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import troy_tpu_torch as P

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

# A tiny BFV flow in a fresh interpreter in which importing jax or flax
# raises; afterwards neither may be in sys.modules.
FLOW = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    assert "jax" not in sys.modules

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax"):
                raise ImportError(f"troy_tpu_torch imported {name}")
            return None

    sys.meta_path.insert(0, _NoJax())

    import numpy as np
    import torch
    import troy_tpu_torch as P
    from troy_tpu_torch import prng

    n = 64
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [40, 40, 40])),
        plain_modulus=P.PlainModulus.batching(n, 17))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    kg = P.KeyGenerator(ctx, seed=prng.seed_from_uint64(1), host_sampling=True)
    be = P.BatchEncoder(ctx)
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=prng.seed_from_uint64(2), host_sampling=True)
    t = be.plain_modulus
    a = np.arange(n, dtype=np.uint64) % t
    ev = P.Evaluator(ctx)
    ct = ev.relinearize(ev.multiply(enc.encrypt_symmetric(be.encode(a)),
                                    enc.encrypt_symmetric(be.encode(a))),
                        kg.create_relin_keys())
    dec = P.Decryptor(ctx, kg.secret_key)
    got = be.decode(dec.decrypt(ct))
    assert (got == (a * a) % t).all(), "wrong product"
    rot = ev.rotate_rows(ct, 1, kg.create_galois_keys(steps=[1]))
    want = np.concatenate([np.roll(got[:n // 2], -1), np.roll(got[n // 2:], -1)])
    assert (be.decode(dec.decrypt(rot)) == want).all(), "wrong rotation"
    ms = ev.mod_switch_to_next(ct)
    assert (be.decode(dec.decrypt(ms)) == got).all(), "wrong mod switch"
    assert dec.invariant_noise_budget(ms) > 0

    # the default path: device sampling, the public key, seed compression,
    # batched encryption, a switching key of an external secret key
    from troy_tpu_torch import rlwe
    pk = kg.create_public_key()
    denc = P.Encryptor(ctx, pk, kg.secret_key, prng.seed_from_uint64(8))
    pa = be.encode(a)
    ss = denc.encrypt_symmetric(pa, save_seed=True)
    dropped = ss.replace(data=torch.stack([ss.data[0], ss.data[1] * 0]),
                         seed=ss.seed)
    for c in (denc.encrypt(pa), denc.encrypt_symmetric(pa),
              rlwe.expand_seed(dropped, ctx.first_context_data),
              *denc.encrypt_symmetric_many([pa, pa])):
        assert (be.decode(dec.decrypt(c)) == a).all(), "wrong encryption"
    ext = P.KeyGenerator(ctx, kg.secret_key, prng.seed_from_uint64(9))
    sq = ev.relinearize(ev.multiply(ss, ss), ext.create_relin_keys())
    assert (be.decode(dec.decrypt(sq)) == (a * a) % t).all(), "wrong key"

    # CKKS: encode, encrypt, multiply, relinearize, rescale, rotate_vector,
    # complex_conjugate, decrypt, decode
    cparms = P.EncryptionParameters(
        scheme=P.SchemeType.ckks, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [50, 40, 50])))
    cctx = P.HeContext(cparms, sec_level=P.SecurityLevel.none, device="cpu")
    ckg = P.KeyGenerator(cctx, seed=prng.seed_from_uint64(3),
                         host_sampling=True)
    ce = P.CKKSEncoder(cctx)
    cenc = P.Encryptor(cctx, secret_key=ckg.secret_key,
                       seed=prng.seed_from_uint64(4), host_sampling=True)
    v = np.linspace(-1, 1, n // 2) + 0.5j
    cv = cenc.encrypt_symmetric(ce.encode(v, 2.0 ** 30))
    cev = P.Evaluator(cctx)
    cdec = P.Decryptor(cctx, ckg.secret_key)
    sq = cev.rescale_to_next(cev.relinearize(cev.multiply(cv, cv),
                                             ckg.create_relin_keys()))
    assert np.abs(ce.decode(cdec.decrypt(sq)) - v * v).max() < 1e-3
    cgk = ckg.create_galois_keys(steps=[1, 0])
    assert np.abs(ce.decode(cdec.decrypt(cev.rotate_vector(cv, 1, cgk)))
                  - np.roll(v, -1)).max() < 1e-3
    assert np.abs(ce.decode(cdec.decrypt(cev.complex_conjugate(cv, cgk)))
                  - np.conj(v)).max() < 1e-3
    assert np.abs(ce.decode(cdec.decrypt(cev.add_plain(
        cv, ce.encode(v, 2.0 ** 30)))) - 2 * v).max() < 1e-3

    # BGV: encrypt, multiply, relinearize, mod switch (correction factor),
    # rotate_rows, add with unequal factors, plain ops, decrypt, budget
    bparms = P.EncryptionParameters(
        scheme=P.SchemeType.bgv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [40, 40, 40])),
        plain_modulus=P.PlainModulus.batching(n, 17))
    bctx = P.HeContext(bparms, sec_level=P.SecurityLevel.none, device="cpu")
    bkg = P.KeyGenerator(bctx, seed=prng.seed_from_uint64(5),
                         host_sampling=True)
    bbe = P.BatchEncoder(bctx)
    benc = P.Encryptor(bctx, secret_key=bkg.secret_key,
                       seed=prng.seed_from_uint64(6), host_sampling=True)
    bev = P.Evaluator(bctx)
    bdec = P.Decryptor(bctx, bkg.secret_key)
    bt = bbe.plain_modulus
    ba = benc.encrypt_symmetric(bbe.encode(a))
    bms = bev.mod_switch_to_next(bev.relinearize(bev.multiply(ba, ba),
                                                 bkg.create_relin_keys()))
    assert bms.correction_factor != 1
    sq = (a * a) % bt
    assert (bbe.decode(bdec.decrypt(bms)) == sq).all(), "wrong BGV product"
    bsum = bev.add(bms, bev.mod_switch_to_next(ba))
    assert (bbe.decode(bdec.decrypt(bsum)) == (sq + a) % bt).all()
    bmp = bev.multiply_plain(ba, bbe.encode(a))
    assert (bbe.decode(bdec.decrypt(bmp)) == sq).all()
    brot = bev.rotate_rows(ba, 1, bkg.create_galois_keys(steps=[1]))
    want = np.concatenate([np.roll(a[:n // 2], -1), np.roll(a[n // 2:], -1)])
    assert (bbe.decode(bdec.decrypt(brot)) == want).all(), "wrong rotation"
    assert bdec.invariant_noise_budget(bms) > 0

    # hoisted Galois, the negacyclic shift, LWE extract, pack and trace,
    # BFV and BGV (coefficient form too)
    for c, k, e, d, enc_ in ((ct, kg, ev, dec, be), (ba, bkg, bev, bdec, bbe)):
        pa = enc_.encode_polynomial(a)
        fresh = (benc if k is bkg else enc).encrypt_symmetric(pa)
        ak = k.create_automorphism_keys()
        packed = e.pack_lwe_ciphertexts(e.extract_lwe_many(fresh, [0, 3, 9]),
                                        ak)
        out = enc_.decode_polynomial(d.decrypt(packed))
        assert list(out[::16][:3]) == [a[0], a[3], a[9]], "wrong pack"
        coeff = e.transform_from_ntt(fresh) if fresh.is_ntt_form else fresh
        shifted = enc_.decode_polynomial(d.decrypt(e.negacyclic_shift(coeff,
                                                                      1)))
        assert shifted[1] == a[0] and shifted[0] == (-int(a[-1])) % t
        gk2 = k.create_galois_keys(steps=[1, 2])
        for src in (c, coeff):
            ms = e.rotate_many(src, [1, 2], gk2)
            want1 = np.concatenate([np.roll(enc_.decode(d.decrypt(src))[
                :n // 2], -1), np.roll(enc_.decode(d.decrypt(src))[n // 2:],
                                       -1)])
            assert (enc_.decode(d.decrypt(ms[0])) == want1).all(), "hoist"
    # the app layer: a packed ct x pt matmul, a ct x ct conv2d and a CKKS
    # matmul through the wire and the batched decryption
    from troy_tpu_torch.app.linear import (Cipher2d, Conv2dHelper,
                                           MatmulHelper)
    x = np.arange(6 * 8, dtype=np.uint64).reshape(6, 8) % 7
    w = np.arange(8 * 40, dtype=np.uint64).reshape(8, 40) % 5
    h = MatmulHelper(6, 8, 40, n, objective=0, pack_lwe=True)
    y = h.pack_outputs(ev, kg.create_automorphism_keys(), h.matmul(
        ev, h.encrypt_inputs(denc, be.encode_polynomial, x),
        h.encode_weights(be.encode_polynomial, w)))
    y = h.deserialize_outputs(ev, ctx, h.serialize_outputs(ev, ctx, y))
    got = h.decrypt_outputs(be.decode_polynomial, dec, y)
    assert (got.astype(np.uint64) == (x @ w) % t).all(), "wrong matmul"
    img = np.arange(2 * 16, dtype=np.uint64).reshape(1, 2, 4, 4) % 5
    ker = np.arange(2 * 2 * 4, dtype=np.uint64).reshape(2, 2, 2, 2) % 3
    ch = Conv2dHelper(1, 4, 4, 2, 2, 2, 2, n)
    xc = Cipher2d.load(ch.encrypt_inputs(denc, be.encode_polynomial,
                                         img).save(ctx), ctx)
    yc = ch.conv2d_cipher(ev, xc, ch.encode_weights(
        be.encode_polynomial, ker).encrypt_symmetric(denc))
    conv = ch.decrypt_outputs(be.decode_polynomial, dec, yc)
    assert conv[0, 1, 2, 0] == sum(int(img[0, c, 2 + i, j] * ker[1, c, i, j])
                                   for c in range(2) for i in range(2)
                                   for j in range(2)) % t, "wrong conv"
    cenc2 = P.Encryptor(cctx, secret_key=ckg.secret_key,
                        seed=prng.seed_from_uint64(5))
    ep = lambda c: ce.encode_polynomial(c, 2.0 ** 30)
    cm = MatmulHelper(2, 3, 4, n, objective=0, pack_lwe=False)
    xf, wf = np.linspace(-1, 1, 6).reshape(2, 3), np.linspace(0, 1, 12)
    wf = wf.reshape(3, 4)
    cy = cm.matmul(cev, cm.encrypt_inputs(cenc2, ep, xf),
                   cm.encode_weights(ep, wf))
    cgot = cm.decrypt_outputs(ce.decode_polynomial, cdec, cy)
    assert np.abs(cgot.astype(np.float64) - xf @ wf).max() < 1e-3
    # kernel J and the native runtime: a context on J (use_mxu=True) at
    # n = 2048, host keygen through the native XOF
    from troy_tpu_torch import native
    assert native.available(), native.build_error
    jparms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=2048,
        coeff_modulus=tuple(P.CoeffModulus.create(2048, [50, 40, 50])),
        plain_modulus=P.PlainModulus.batching(2048, 20))
    jctx = P.HeContext(jparms, sec_level=P.SecurityLevel.none, device="cpu",
                       use_mxu=True)
    assert jctx.first_context_data.ntt.mxu is not None
    jkg = P.KeyGenerator(jctx, seed=prng.seed_from_uint64(11),
                         host_sampling=True)
    jbe = P.BatchEncoder(jctx)
    jenc = P.Encryptor(jctx, secret_key=jkg.secret_key,
                       seed=prng.seed_from_uint64(12))
    ja = np.arange(2048, dtype=np.uint64) % jbe.plain_modulus
    jev = P.Evaluator(jctx)
    jc = jenc.encrypt_symmetric(jbe.encode(ja))
    jsq = jev.relinearize(jev.multiply(jc, jc), jkg.create_relin_keys())
    jdec = P.Decryptor(jctx, jkg.secret_key)
    assert (jbe.decode(jdec.decrypt(jev.mod_switch_to_next(jsq)))
            == (ja * ja) % jbe.plain_modulus).all(), "wrong product on J"
    # troy's binder API on the port: a two-party CKKS exchange in both
    # wires, the device statistics, and the host modules
    import troy_tpu_torch.compat as pytroy
    from troy_tpu_torch import functional, hexpoly, refwire, valcheck
    from troy_tpu_torch.utils import profiling
    sp = pytroy.EncryptionParameters(pytroy.SchemeType.ckks)
    sp.set_poly_modulus_degree(n)
    sp.set_coeff_modulus(pytroy.CoeffModulus.create(n, [50, 40, 50]))
    sctx = pytroy.SEALContext(sp, True, pytroy.SecurityLevel.none,
                              device="cpu")
    skg = pytroy.KeyGenerator(sctx)
    sce = pytroy.CKKSEncoder(sctx)
    senc = pytroy.Encryptor(sctx, skg.create_public_key())
    sev = pytroy.Evaluator(sctx)
    sc = pytroy.Ciphertext()
    sc.load(senc.encrypt(sce.encode([1.0, 2.0], 2.0 ** 30)).save(sctx,
                                                                 wire="troy"),
            sctx)
    sev.square_inplace(sc)
    sev.relinearize_inplace(sc, skg.create_relin_keys())
    sback = pytroy.Ciphertext()
    sback.load(sc.save())
    sout = sce.decode(pytroy.Decryptor(sctx, skg.secret_key()).decrypt(sback))
    assert np.abs(sout[:2] - [1.0, 4.0]).max() < 1e-3, "wrong shim flow"
    plain, stats = ce.encode_with_stats(v, 2.0 ** 30)
    assert stats.max_coeff_bit_count > 1
    assert 0 <= ce.decode_max_error(plain) < 1e-8
    assert valcheck.is_valid_for(cv, cctx)
    assert hexpoly.poly_to_hex_string([1, 0, 3]) == "3x^2 + 1"
    assert refwire.load_ciphertext_ref(refwire.save_ciphertext_ref(cv, cctx),
                                       cctx).data.equal(cv.data)
    fsq = functional.multiply(cv, cv, cctx.first_context_data)
    assert fsq.data.equal(cev.multiply(cv, cv).data)
    timer = profiling.Timer()
    with timer.measure("op"):
        pass
    # multi-device: the limb-sharded mult+relin in two spawned gloo ranks,
    # which import no JAX either
    from troy_tpu_torch.parallel import sharding, spmd
    c_in = enc.encrypt_symmetric(be.encode(a))
    rlk = kg.create_relin_keys()
    spec = {"contexts": {"bfv": {
                "scheme": "bfv", "n": n, "t": int(t),
                "q": list(ctx.key_context_data.coeff_values)}},
            "keys": {"rlk": P.interop.words(rlk)},
            "jobs": [{"name": "limb", "regime": "limb_multiply_relin",
                      "context": "bfv", "key": "rlk",
                      "inputs": [P.interop.words(c_in)] * 2}]}
    ranks = sharding.spawn(spmd.run_jobs, 2, "gloo", "cpu", (spec,),
                           timeout_s=120)
    assert not any(r["jax_loaded"] for r in ranks), "a rank imported JAX"
    want = P.interop.words(ev.relinearize(ev.multiply(c_in, c_in), rlk))
    assert (ranks[0]["results"]["limb"]["out"] == want).all(), "sharded"
    for mod in ("troy_tpu_torch.ckks", "troy_tpu_torch.ops.embedding",
                "troy_tpu_torch.ops.sampling", "troy_tpu_torch.app.linear",
                "troy_tpu_torch.serialization", "troy_tpu_torch.ops.tiles",
                "troy_tpu_torch.ops.ntt_mxu", "troy_tpu_torch.native",
                "troy_tpu_torch.compat", "troy_tpu_torch.refwire",
                "troy_tpu_torch.functional", "troy_tpu_torch.valcheck",
                "troy_tpu_torch.hexpoly", "troy_tpu_torch.utils.profiling",
                "troy_tpu_torch.parallel.sharding",
                "troy_tpu_torch.parallel.spmd", "troy_tpu_torch.ops.shard"):
        assert mod in sys.modules, mod
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    assert not loaded, loaded
    print("no-jax flow ok")
""")


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-I", "-c", FLOW, str(REPO)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax flow ok" in proc.stdout


# The port-side tools that the CPU suites and chip_smoke.py's phase 36
# share, in a fresh interpreter in which importing jax, flax or troy_tpu
# raises: the CKKS precision chain (at n = 64 here), a fixture case and a
# fuzz sequence.
TOOLS_FLOW = textwrap.dedent("""
    import sys
    repo = sys.argv[1]
    sys.path[:0] = [repo, f"{repo}/tools"]
    FORBIDDEN = ("jax", "jaxlib", "flax", "troy_tpu")

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(f"a tool imported {name}")
            return None

    sys.meta_path.insert(0, _NoJax())
    import ckks_precision_torch
    import fuzz_torch
    import troy_vectors_torch as tv
    rows, meta = ckks_precision_torch.run(n=64, trials=1, device="cpu")
    assert meta["depth"] == 3 and len(rows) == 8, rows
    assert min(r["precision_bits"] for r in rows) > 15, rows
    assert tv.verify(tv.behz_multiply("cpu")) == 1
    assert fuzz_torch.ckks_sequence(0, "cpu") >= 1
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    assert not loaded, loaded
    print("no-jax tools ok")
""")


def test_tools_import_no_jax():
    proc = subprocess.run([sys.executable, "-I", "-c", TOOLS_FLOW,
                           str(REPO)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax tools ok" in proc.stdout


def test_cuda_context_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=64,
        coeff_modulus=tuple(P.CoeffModulus.create(64, [40, 40])),
        plain_modulus=P.PlainModulus.batching(64, 17))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cuda")


def test_context_defaults_to_the_card():
    """With no device named, the context is made on the card, and without
    one it raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=64,
        coeff_modulus=tuple(P.CoeffModulus.create(64, [40, 40])),
        plain_modulus=P.PlainModulus.batching(64, 17))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.HeContext(parms, sec_level=P.SecurityLevel.none)
    with pytest.raises((RuntimeError, AssertionError)):
        P.interop.secret_key(np.zeros((2, 64), dtype=np.uint64))


def test_ckks_context_defaults_to_the_card():
    """A CKKS context, too, is made on the card unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.ckks, poly_modulus_degree=64,
        coeff_modulus=tuple(P.CoeffModulus.create(64, [50, 40, 50])))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.HeContext(parms, sec_level=P.SecurityLevel.none)
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    assert P.CKKSEncoder(ctx)._emb.device.type == "cpu"


def test_bgv_context_defaults_to_the_card():
    """A BGV context, too, is made on the card unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bgv, poly_modulus_degree=64,
        coeff_modulus=tuple(P.CoeffModulus.create(64, [40, 40])),
        plain_modulus=P.PlainModulus.batching(64, 17))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.HeContext(parms, sec_level=P.SecurityLevel.none)
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    assert ctx.first_context_data.exact_to_t.consts.device.type == "cpu"


def test_wrappers_run_the_plain_version_only_on_the_cpu():
    """A tensor that is not on the CPU never takes the plain path: the
    wrapper launches the kernel or raises."""
    from troy_tpu_torch.ops import (embedding, galois, keyswitch, ntt, poly,
                                    rns, sampling, tiles)
    from troy_tpu_torch.utils.rns import make_rns_tool

    n = 64
    q = tuple(int(m) for m in P.CoeffModulus.create(n, [40, 40]))
    t = int(P.PlainModulus.batching(n, 17))
    tables = ntt.RnsNttTables.from_moduli(n, q, "cpu")
    tool = make_rns_tool(n, q, t)
    conv = rns.DeviceConverter.build(tool.conv_q_to_Bsk, "cpu")
    dtool = rns.DeviceRnsTool.build(tool, tables, ntt.RnsNttTables.from_moduli(
        n, tool.base_Bsk.values, "cpu"))
    src, keep = galois.coeff_permutation(n, 3, "cpu")
    consts = keyswitch.divide_round_consts(tables.slice(0, 1), q[-1])
    bgv = keyswitch.bgv_divide_consts(tables.slice(0, 1), q[-1], t)
    exact = rns.ExactConverter.build(tool.conv_q_to_t, "cpu")
    meta = lambda *shape, dtype=torch.int64: torch.zeros(shape, dtype=dtype,
                                                         device="meta")
    x = meta(2, n)
    emb = embedding.make_embed_tables(n, "cpu")
    on_j = ntt.RnsNttTables.from_moduli(
        2048, [int(m) for m in P.CoeffModulus.create(2048, [40, 40])], "cpu",
        use_mxu=True)
    rt = embedding.make_rns_round_tables(tables)
    for call in (lambda: ntt.rns_ntt_forward(meta(2, 2048), on_j),
                 lambda: ntt.rns_ntt_inverse(meta(2, 2048), on_j),
                 lambda: ntt.rns_ntt_forward(x, tables),
                 lambda: ntt.rns_ntt_inverse(x, tables),
                 lambda: ntt.rns_dyadic_mul(x, x, tables),
                 lambda: poly.rns_add(x, x, tables),
                 lambda: rns.fast_convert(x, conv),
                 lambda: rns.behz_lift(x, dtool),
                 lambda: rns.behz_tail(meta(2 + dtool.nb, n), dtool),
                 lambda: rns.decrypt_scale_and_round(x, dtool),
                 lambda: keyswitch.keyswitch_digits(meta(n), tables),
                 lambda: keyswitch.divide_round_last(meta(1, 2, n), consts),
                 lambda: keyswitch.ntt_inverse_divide_round(
                     meta(1, 2, n), tables, consts),
                 lambda: keyswitch.divide_and_round_q_last(meta(1, 2, n),
                                                           tables),
                 lambda: poly.bfv_plain_embed(meta(n), x, t, 1, (1, 1),
                                              tables),
                 lambda: galois.apply_permutation_signed(x, src, keep, tables),
                 lambda: galois.apply_permutation(x, src),
                 lambda: embedding.embed_inverse_fft(
                     meta(n // 2, dtype=torch.complex128), emb),
                 lambda: embedding.embed_forward(
                     meta(n, dtype=torch.float64), emb),
                 lambda: embedding.untwist_round_to_rns(
                     meta(n, dtype=torch.complex128), 1.0, emb, rt),
                 lambda: embedding.untwist_round_to_rns_stats(
                     meta(n, dtype=torch.complex128), 1.0, emb, rt),
                 lambda: embedding.embed_forward_stats(
                     meta(n, dtype=torch.float64), emb),
                 lambda: embedding.compose_centered(x, rt),
                 lambda: rns.divide_and_round_q_last_ntt(
                     meta(1, 2, n), tables, consts),
                 lambda: rns.divide_round_last_ntt(
                     meta(1, 2, n), tables.slice(0, 1), tables.slice(1, 2),
                     consts),
                 lambda: rns.divide_round_last_ntt(
                     meta(1, 2, n), tables.slice(0, 1), tables.slice(1, 2),
                     bgv, None, rns.BGV_KEYSWITCH),
                 lambda: rns.mod_t_and_divide_q_last_ntt(meta(1, 2, n),
                                                         tables, bgv),
                 lambda: rns.exact_convert(x, exact),
                 lambda: rns.decrypt_mod_t(x, exact, 3),
                 lambda: poly.plain_lift(meta(n), tables, t, (t + 1) // 2,
                                         q[0] * q[1], 5),
                 lambda: sampling.sample_uniform_rns(meta(3), tables),
                 lambda: sampling.sample_cbd_rns(meta(3), tables, t),
                 lambda: sampling.sample_ternary_rns(meta(3), tables),
                 lambda: poly.negacyclic_shift(x, 3, tables),
                 lambda: poly.negacyclic_shift(x, meta(2), tables),
                 lambda: poly.extract_lwe_many(meta(2, 2, n), meta(3),
                                               tables),
                 lambda: poly.assemble_lwe(meta(1, 2, n), meta(1, 2), 0,
                                           tables),
                 lambda: poly.pack_fold_prepare(meta(2, 2, 2, n), 8, tables),
                 lambda: galois.permute_batched(
                     meta(2, 2, 2, n), galois.batched_tables(n, (3, 5),
                                                             "cpu", True),
                     tables),
                 lambda: ntt.dyadic_mac_batched(meta(2, 2, 2, n),
                                                meta(3, 2, 2, n), tables),
                 lambda: keyswitch.bgv_divide_last(meta(1, 2, n), bgv),
                 lambda: rns.mod_t_and_divide_q_last(meta(1, 2, n), tables,
                                                     bgv),
                 lambda: embedding.round_to_rns(meta(n, dtype=torch.float64),
                                                1.0, rt),
                 lambda: tiles.tile_contract(meta(1, 3, 2, 2, n),
                                             meta(3, 4, 2, n), tables),
                 lambda: tiles.tile_pair_convolve(meta(1, 2, 2, n),
                                                  meta(4, 2, 2, n), tables),
                 lambda: tiles.pack_group_fold(meta(5, 2, 2, n), 4,
                                               tables)):
        with pytest.raises(ValueError, match="expected all on the CPU"):
            call()


def test_constructors_take_the_reference_argument_order():
    """Encryptor(context, public_key, secret_key, seed, host_sampling) and
    KeyGenerator(context, secret_key, seed, host_sampling), in troy_tpu's
    order (troy_tpu/encryptor.py:83-87, troy_tpu/keygen.py:71-74), so that
    positional callers are read as they mean."""
    import inspect
    assert list(inspect.signature(P.Encryptor).parameters) == [
        "context", "public_key", "secret_key", "seed", "host_sampling"]
    assert list(inspect.signature(P.KeyGenerator).parameters) == [
        "context", "secret_key", "seed", "host_sampling"]
    n = 64
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [40, 40, 40])),
        plain_modulus=P.PlainModulus.batching(n, 17))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    kg = P.KeyGenerator(ctx, None, P.prng.seed_from_uint64(1))
    other = P.KeyGenerator(ctx, kg.secret_key)
    assert other.secret_key is kg.secret_key
    pk = kg.create_public_key()
    enc = P.Encryptor(ctx, pk)
    be = P.BatchEncoder(ctx)
    a = np.arange(n, dtype=np.uint64)
    got = be.decode(P.Decryptor(ctx, kg.secret_key).decrypt(
        enc.encrypt(be.encode(a))))
    np.testing.assert_array_equal(got, a)
    with pytest.raises(ValueError, match="no secret key"):
        enc.encrypt_symmetric(be.encode(a))
    with pytest.raises(ValueError, match="no public key"):
        P.Encryptor(ctx, None, kg.secret_key).encrypt(be.encode(a))


def test_save_seed_with_host_sampling_raises():
    """host_sampling is a path the caller asks for, and it has no
    seed-compressed form: asking for one raises."""
    n = 64
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, [40, 40])),
        plain_modulus=P.PlainModulus.batching(n, 17))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    kg = P.KeyGenerator(ctx, seed=P.prng.seed_from_uint64(1))
    enc = P.Encryptor(ctx, secret_key=kg.secret_key, host_sampling=True)
    plain = P.BatchEncoder(ctx).encode(np.zeros(n, dtype=np.uint64))
    with pytest.raises(ValueError, match="save_seed"):
        enc.encrypt_symmetric(plain, save_seed=True)


def test_slice_six_names_and_signatures():
    """The names this package exports for the hoisted Galois path and LWE,
    and their parameters in troy_tpu's order (troy_tpu/evaluator.py
    :1199-1500, troy_tpu/encoder.py:85-118, troy_tpu/ckks.py:263)."""
    import inspect
    for name in ("LWECiphertext", "EncodeStats"):
        assert name in P.__all__ and hasattr(P, name)
    params = lambda f: list(inspect.signature(f).parameters)
    ev = P.Evaluator
    assert params(ev.apply_galois_many) == ["self", "ct", "elts",
                                            "galois_keys"]
    assert params(ev.rotate_many) == ["self", "ct", "steps", "galois_keys"]
    assert params(ev.negacyclic_shift) == ["self", "ct", "shift"]
    assert params(ev.extract_lwe) == ["self", "ct", "term"]
    assert params(ev.extract_lwe_many) == ["self", "ct", "terms"]
    assert params(ev.assemble_lwe) == ["self", "lwe", "term"]
    assert params(ev.divide_by_poly_modulus_degree) == ["self", "ct", "mul"]
    assert params(ev.field_trace) == ["self", "ct", "automorphism_keys",
                                      "logn"]
    assert params(ev.pack_lwe_ciphertexts) == ["self", "lwes",
                                               "automorphism_keys"]
    be = P.BatchEncoder
    assert params(be.encode_signed) == ["self", "values"]
    assert params(be.decode_signed) == ["self", "plain"]
    assert params(be.encode_polynomial) == ["self", "values"]
    assert params(be.decode_polynomial) == ["self", "plain", "count"]
    assert params(P.CKKSEncoder.encode_int64) == ["self", "value", "level"]
    assert "internal_prime_bits" in params(P.HeContext)
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=64,
        coeff_modulus=tuple(P.CoeffModulus.create(64, [40, 40, 40])),
        plain_modulus=P.PlainModulus.batching(64, 17))
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device="cpu")
    assert ctx.last_context_data is ctx.chain[-1]
    assert ctx.get_context_data_by_parms_id(ctx.chain[1].parms_id) \
        is ctx.chain[1]
    assert ctx.plain_ntt.rns.k == 1
    assert list(P.LWECiphertext.__dataclass_fields__) == [
        "c1", "c0", "level", "scale", "correction_factor"]


def test_slice_seven_names_and_signatures():
    """The app layer, the wire format and the batched decryption, with
    troy_tpu's parameter order (troy_tpu/app/linear.py,
    troy_tpu/serialization.py, troy_tpu/decryptor.py:124,
    troy_tpu/ckks.py:269/383)."""
    import inspect
    from troy_tpu_torch import serialization
    from troy_tpu_torch.app import linear
    params = lambda f: list(inspect.signature(f).parameters)
    assert params(P.Decryptor.decrypt_many) == ["self", "cts"]
    assert params(P.CKKSEncoder.encode_polynomial) == ["self", "coeffs",
                                                       "scale", "level"]
    assert params(P.CKKSEncoder.decode_polynomial) == ["self", "plain",
                                                       "count"]
    assert params(linear.MatmulHelper) == [
        "batch_size", "input_dims", "output_dims", "slot_count", "objective",
        "pack_lwe"]
    assert params(linear.Conv2dHelper) == [
        "batch_size", "image_height", "image_width", "kernel_height",
        "kernel_width", "input_channels", "output_channels", "slot_count",
        "objective"]
    for name in ("save_ciphertext", "load_ciphertext", "save_terms",
                 "load_terms", "save_plaintext", "load_plaintext",
                 "save_public_key", "load_public_key", "save_secret_key",
                 "load_secret_key", "save_relin_keys", "load_relin_keys",
                 "save_galois_keys", "load_galois_keys", "save_kswitch_keys",
                 "load_kswitch_keys", "save_parms", "load_parms",
                 "fetch_ciphertexts_host"):
        assert callable(getattr(serialization, name)), name
    # loads without a context put their tensors on the card by default
    for load in (serialization.load_plaintext, serialization.load_secret_key,
                 serialization.load_galois_keys,
                 linear.MatmulHelper.deserialize_encoded_weights):
        assert inspect.signature(load).parameters["device"].default == "cuda"
