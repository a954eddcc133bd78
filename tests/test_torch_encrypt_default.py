"""Encryption the way users call it, troy_tpu_torch against troy_tpu on the
CPU: device sampling from threefry streams, public-key encryption,
seed-compressed ciphertexts and device switching keys.

BFV, CKKS and BGV at n = 1024 (q = {60,40,40,60}) and n = 4096
(q = {60,40,40,40,60}), t = PlainModulus.batching(n, 20), CKKS at scale
2^40, SecurityLevel.none. A seeded KeyGenerator and Encryptor in each
package, with no host_sampling, make the public key (both forms), encrypt,
encrypt_symmetric (with and without save_seed, then expand_seed),
encrypt_symmetric_many of 3, encrypt_zero in both forms, the relin and
automorphism keys of an external secret key (kernel Q) and a
key-switching key from an old secret key. Each is compared with troy_tpu's
word for word (tolerance 0) and decrypted through the port: ciphertexts of
a plaintext to its slots (CKKS within 1e-4), zero encryptions and public
keys to a phase within their noise bound, the keys by what they switch.
Both packages get the same plaintext words (troy_tpu's encode).
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng
from troy_tpu import rlwe as jrlwe

import troy_tpu_torch as P
from troy_tpu_torch import interop, rlwe
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.ops import ntt, poly

torch.set_num_threads(2)

SEED = 5150
SCALE = 2.0 ** 40
CONFIGS = {"n1024": (1024, [60, 40, 40, 60]),
           "n4096": (4096, [60, 40, 40, 40, 60])}
SCHEMES = ("bfv", "ckks", "bgv")
CBD_MAX = 21                      # |CBD noise| <= 21
CASES = ("public_key", "public_key_save_seed", "encrypt",
         "encrypt_symmetric", "encrypt_symmetric_save_seed", "expand_seed",
         "encrypt_symmetric_many", "encrypt_zero_asymmetric",
         "encrypt_zero_symmetric", "relin_keys_external_sk",
         "automorphism_keys_external_sk", "keyswitch_key")


def _ctx(mod, scheme, name):
    n, bits = CONFIGS[name]
    extra = {} if scheme == "ckks" else {
        "plain_modulus": mod.PlainModulus.batching(n, 20)}
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(mod.CoeffModulus.create(n, bits)), **extra)
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)


def _np(x):
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _values(scheme, ctx, n):
    """Three slot vectors of the scheme."""
    rng = np.random.default_rng(SEED)
    if scheme == "ckks":
        return [rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
                for _ in range(3)]
    t = int(ctx.first_context_data.plain_modulus)
    return [rng.integers(0, t, n, dtype=np.uint64) for _ in range(3)]


def _run(mod, scheme, name, plains):
    """Everything the cases compare, made by one package from the seeds."""
    prng = tprng if mod is P else jprng
    ctx = _ctx(mod, scheme, name)
    kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED))
    pk = kg.create_public_key()
    enc = mod.Encryptor(ctx, pk, kg.secret_key,
                        seed=prng.seed_from_uint64(SEED + 1))
    out = {"ctx": ctx, "kg": kg, "plain": plains[0], "public_key": pk,
           "public_key_save_seed": kg.create_public_key(save_seed=True),
           "encrypt": enc.encrypt(plains[0]),
           "encrypt_symmetric": enc.encrypt_symmetric(plains[0])}
    ss = enc.encrypt_symmetric(plains[0], save_seed=True)
    out["encrypt_symmetric_save_seed"] = ss
    # a received seed-compressed ciphertext: c1 gone, the seed kept
    if mod is P:
        dropped = torch.cat([ss.data[:1], torch.zeros_like(ss.data[1:2]),
                             ss.data[2:]])
        expand = rlwe.expand_seed
    else:
        dropped = ss.data.at[1].set(0)
        expand = jrlwe.expand_seed
    out["expand_seed"] = expand(ss.replace(data=dropped, seed=ss.seed),
                                ctx.get_context_data(ss.level))
    out["encrypt_symmetric_many"] = enc.encrypt_symmetric_many(plains)
    out["encrypt_zero_asymmetric"] = enc.encrypt_zero()
    out["encrypt_zero_symmetric"] = enc.encrypt_zero(asymmetric=False,
                                                     save_seed=True)
    ext = mod.KeyGenerator(ctx, secret_key=kg.secret_key,
                           seed=prng.seed_from_uint64(SEED + 2))
    out["relin_keys_external_sk"] = ext.create_relin_keys()
    out["automorphism_keys_external_sk"] = ext.create_automorphism_keys()
    new = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED + 3))
    out["new_kg"] = new
    out["keyswitch_key"] = new.create_keyswitch_key(kg.secret_key)
    return out


@pytest.fixture(scope="module",
                params=[(s, n) for s in SCHEMES for n in sorted(CONFIGS)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request):
    """Both packages' results for one scheme and size, from the same seeds
    and the same plaintext words."""
    scheme, name = request.param
    n = CONFIGS[name][0]
    jctx = _ctx(J, scheme, name)
    vals = _values(scheme, jctx, n)
    if scheme == "ckks":
        enc = J.CKKSEncoder(jctx)
        jplains = [enc.encode(v, SCALE) for v in vals]
    else:
        enc = J.BatchEncoder(jctx)
        jplains = [enc.encode(v) for v in vals]
    pplains = [interop.plaintext(_np(p.data), "cpu", p.level, p.is_ntt_form,
                                 p.scale) for p in jplains]
    return {"scheme": scheme, "vals": vals, J: _run(J, scheme, name, jplains),
            P: _run(P, scheme, name, pplains)}


def _words(obj):
    """(words, seed) of a ciphertext or public key; each key's words of a
    switching key; a list of those of a list."""
    if isinstance(obj, list):
        return [_words(o) for o in obj]
    if hasattr(obj, "keys"):
        return {int(k): _np(v) for k, v in obj.keys.items()}
    return _np(obj.data), int(obj.seed)


def _same(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1], "seeds differ"


def _decode(run, scheme, ct, sk=None):
    ctx = run["ctx"]
    dec = P.Decryptor(ctx, sk if sk is not None else run["kg"].secret_key)
    enc = P.CKKSEncoder(ctx) if scheme == "ckks" else P.BatchEncoder(ctx)
    return enc.decode(dec.decrypt(ct))


def _check_slots(scheme, got, want, tol=1e-4):
    if scheme == "ckks":
        assert float(np.abs(got - want).max()) < tol
    else:
        np.testing.assert_array_equal(got, want)


def _check_phase(ctx, sk, data, level, ntt_form, bound):
    """c0 + c1 s of a zero encryption is one small integer per coefficient,
    the same in every limb, within ``bound`` (times t, and a multiple of t,
    for BGV)."""
    cd = ctx.get_context_data(level)
    tab = cd.ntt
    sk = sk.data[:cd.limbs]
    c = data if ntt_form else ntt.rns_ntt_forward(data, tab)
    phase = ntt.rns_ntt_inverse(
        poly.rns_add(c[0], ntt.rns_dyadic_mul(c[1], sk, tab), tab), tab)
    w = _np(phase).astype(object)
    q = np.array(cd.coeff_values, dtype=object).reshape(-1, 1)
    v = np.where(w > q // 2, w - q, w)
    assert (v == v[0]).all(), "the phase is not small"
    if cd.scheme == P.SchemeType.bgv:
        t = int(cd.plain_modulus)
        assert (v[0] % t == 0).all()
        bound *= t
    assert int(np.abs(v[0]).max()) <= bound


@pytest.mark.parametrize("case", CASES)
def test_default_path_word_equal_and_decrypts(runs, case):
    scheme = runs["scheme"]
    port, ref = runs[P], runs[J]
    _same(_words(port[case]), _words(ref[case]))
    ctx = port["ctx"]
    sk = port["kg"].secret_key
    n = ctx.n
    vals = runs["vals"]
    obj = port[case]
    if case.startswith("public_key"):
        assert (obj.seed != 0) == case.endswith("save_seed")
        ct = obj.as_ciphertext
        _check_phase(ctx, sk, ct.data, ct.level, ct.is_ntt_form, CBD_MAX)
    elif case == "encrypt_symmetric_many":
        for ct, v in zip(obj, vals):
            _check_slots(scheme, _decode(port, scheme, ct), v)
        assert all(ct.seed == 0 for ct in obj)
    elif case.startswith("encrypt_zero"):
        asym = case.endswith("asymmetric")
        assert (obj.seed == 0) == asym
        _check_phase(ctx, sk, obj.data, obj.level, obj.is_ntt_form,
                     CBD_MAX * (2 * n + 1) if asym else CBD_MAX)
    elif case == "relin_keys_external_sk":
        ev = P.Evaluator(ctx)
        ct = port["encrypt"]
        prod = ev.relinearize(ev.multiply(ct, ct), obj)
        if scheme == "ckks":
            prod = ev.rescale_to_next(prod)
            want = vals[0] * vals[0]
        else:
            t = int(ctx.first_context_data.plain_modulus)
            want = (vals[0].astype(object) ** 2 % t).astype(np.uint64)
        _check_slots(scheme, _decode(port, scheme, prod), want, 1e-3)
    elif case == "automorphism_keys_external_sk":
        # element 3 rotates by one step
        ev = P.Evaluator(ctx)
        ct = port["encrypt_symmetric"]
        if scheme == "ckks":
            got, want = ev.rotate_vector(ct, 1, obj), np.roll(vals[0], -1)
        else:
            got = ev.rotate_rows(ct, 1, obj)
            want = np.roll(vals[0].reshape(2, n // 2), -1, axis=1).reshape(-1)
        _check_slots(scheme, _decode(port, scheme, got), want)
    elif case == "keyswitch_key":
        switched = P.Evaluator(ctx).apply_keyswitching(
            port["encrypt_symmetric"], obj)
        got = _decode(port, scheme, switched, port["new_kg"].secret_key)
        _check_slots(scheme, got, vals[0])
    else:
        assert (obj.seed != 0) == case.endswith("save_seed")
        _check_slots(scheme, _decode(port, scheme, obj), vals[0])


def test_public_key_from_words(runs):
    """troy_tpu's public key, carried in as words with its seed, is the
    port's, and encrypts to the same words from the same seeds."""
    ref, port = runs[J], runs[P]
    jpk = ref["public_key_save_seed"]
    pk = interop.public_key(_np(jpk.data), jpk.seed, "cpu")
    np.testing.assert_array_equal(interop.words(pk), _np(jpk.data))
    assert pk.seed == jpk.seed
    jplain = ref["plain"]
    plain = interop.plaintext(_np(jplain.data), "cpu", jplain.level,
                              jplain.is_ntt_form, jplain.scale)
    seed = tprng.seed_from_uint64(SEED + 4)
    ct = P.Encryptor(port["ctx"], pk, seed=seed).encrypt(plain)
    want = J.Encryptor(ref["ctx"], jpk, seed=jprng.seed_from_uint64(
        SEED + 4)).encrypt(jplain)
    np.testing.assert_array_equal(_np(ct.data), _np(want.data))


def test_expand_seed_restores_c1(runs):
    """A seed-compressed ciphertext with its c1 dropped expands to the
    words it was encrypted to, and the expanded one carries no seed; an
    op that rewrites a ciphertext drops its seed."""
    port = runs[P]
    ss, ex = port["encrypt_symmetric_save_seed"], port["expand_seed"]
    assert ss.seed != 0 and ex.seed == 0
    np.testing.assert_array_equal(_np(ex.data), _np(ss.data))
    assert P.Evaluator(port["ctx"]).negate(ss).seed == 0
    assert ss.replace(scale=ss.scale).seed == ss.seed
