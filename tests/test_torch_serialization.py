"""troy_tpu_torch/serialization.py against troy_tpu/serialization.py on the
CPU: the bytes of every ``save_*`` equal troy_tpu's for the same object,
and every stream loads in both packages to the same words.

BFV and BGV at n = 64, CKKS at n = 256, q = {40,40,40}, t =
PlainModulus.batching(64, 20), SecurityLevel.none; seeded host-sampling
keys and seeded default-path encryptions (word-equal in both packages).
Covered: TCT1 ciphertexts (size 2 and 3, coefficient and NTT form, CKKS
scale, BGV correction factor), seed-compressed ciphertexts written by
either package and expanded by the other (c0 and the seed on the wire),
save_terms / load_terms (marker 1 << 63, which a seeded ciphertext
refuses), TPT1 plaintexts (mod t with level 0xFF, NTT form at a level),
TKY1 public, secret, relin, Galois and key-switching keys, TEP1
parameters, and fetch_ciphertexts_host with and without the batched
inverse NTT.
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng
from troy_tpu import serialization as jser

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng
from troy_tpu_torch import serialization as tser

torch.set_num_threads(2)

SEED = 3131
SCALE = 2.0 ** 30
SCHEMES = ["bfv", "ckks", "bgv"]


class Side:
    def __init__(self, mod, scheme):
        self.port = mod is P
        n = 256 if scheme == "ckks" else 64
        self.n = n
        prng = tprng if self.port else jprng
        extra = {} if scheme == "ckks" else {
            "plain_modulus": mod.PlainModulus.batching(n, 20)}
        self.parms = mod.EncryptionParameters(
            scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
            coeff_modulus=tuple(mod.CoeffModulus.create(n, [40, 40, 40])),
            **extra)
        on_cpu = {"device": "cpu"} if self.port else {}
        self.ctx = mod.HeContext(self.parms,
                                 sec_level=mod.SecurityLevel.none, **on_cpu)
        kg = mod.KeyGenerator(self.ctx, seed=prng.seed_from_uint64(SEED),
                              host_sampling=True)
        self.sk = kg.secret_key
        self.pk = kg.create_public_key()
        self.rlk = kg.create_relin_keys()
        self.gk = kg.create_automorphism_keys()
        other = mod.KeyGenerator(self.ctx,
                                 seed=prng.seed_from_uint64(SEED + 1),
                                 host_sampling=True)
        self.ksk = other.create_keyswitch_key(self.sk)
        self.enc = mod.Encryptor(self.ctx, public_key=self.pk,
                                 secret_key=self.sk,
                                 seed=prng.seed_from_uint64(SEED + 2))
        self.ev = mod.Evaluator(self.ctx)
        rng = np.random.default_rng(SEED)
        if scheme == "ckks":
            ce = mod.CKKSEncoder(self.ctx)
            self.plain = ce.encode_polynomial(rng.uniform(-1, 1, n), SCALE)
        else:
            be = mod.BatchEncoder(self.ctx)
            self.plain = be.encode_polynomial(
                rng.integers(0, be.plain_modulus, n, dtype=np.uint64))
        self.ct = self.enc.encrypt_symmetric(self.plain)
        self.seeded = self.enc.encrypt_symmetric(self.plain, save_seed=True)
        self.ct3 = self.ev.multiply(self.ct, self.ct)
        if scheme == "bgv":
            # a correction factor other than 1
            self.ct = self.ev.mod_switch_to_next(self.ct)
        self.coeff = self.ct if not self.ct.is_ntt_form \
            else self.ev.transform_from_ntt(self.ct)

    def words(self, x) -> np.ndarray:
        return interop.to_numpy(x) if self.port else np.asarray(x)


_SIDES = {}


def _sides(scheme):
    if scheme not in _SIDES:
        _SIDES[scheme] = Side(P, scheme), Side(J, scheme)
    return _SIDES[scheme]


def _same(a: np.ndarray, b: np.ndarray):
    assert a.shape == b.shape
    assert int((a != b).sum()) == 0, "words differ"


def _same_ct(pc, jc, port, ref):
    _same(port.words(pc.data), ref.words(jc.data))
    for attr in ("level", "is_ntt_form", "scale", "correction_factor",
                 "seed"):
        assert getattr(pc, attr) == getattr(jc, attr), attr


CT_KINDS = ["ct", "ct3", "coeff"]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kind", CT_KINDS)
def test_ciphertext_bytes_and_loads(scheme, kind):
    port, ref = _sides(scheme)
    pc, jc = getattr(port, kind), getattr(ref, kind)
    raw = tser.save_ciphertext(pc)
    assert raw == jser.save_ciphertext(jc)
    _same_ct(tser.load_ciphertext(raw, port.ctx), jc, port, ref)
    _same_ct(pc, jser.load_ciphertext(raw, ref.ctx), port, ref)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_seed_compressed_across_packages(scheme):
    """c0 and the seed on the wire; either package expands the other's
    stream to the same c1."""
    port, ref = _sides(scheme)
    raw = tser.save_ciphertext(port.seeded)
    assert raw == jser.save_ciphertext(ref.seeded)
    assert len(raw) < len(tser.save_ciphertext(port.ct3)) // 2
    from_ref = tser.load_ciphertext(jser.save_ciphertext(ref.seeded),
                                    port.ctx)
    from_port = jser.load_ciphertext(raw, ref.ctx)
    assert from_ref.seed == 0 and from_port.seed == 0
    _same(port.words(from_ref.data), ref.words(from_port.data))
    _same(port.words(from_ref.data), port.words(port.seeded.data))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_save_terms_and_load_terms(scheme):
    port, ref = _sides(scheme)
    terms = [0, 3, 17, port.n - 1]
    raw = tser.save_terms(port.ct, port.ctx, terms)
    assert raw == jser.save_terms(ref.ct, ref.ctx, terms)
    host = tser.fetch_ciphertexts_host([port.ct], port.ctx, to_coeff=True)[0]
    assert tser.save_terms(port.ct, port.ctx, terms,
                           host_coeff_data=host) == raw
    _same_ct(tser.load_terms(raw, port.ctx, terms),
             jser.load_terms(raw, ref.ctx, terms), port, ref)
    with pytest.raises(ValueError, match="save_terms"):
        tser.load_terms(tser.save_ciphertext(port.ct), port.ctx, terms)
    with pytest.raises(ValueError, match="seed"):
        tser.save_terms(port.seeded, port.ctx, terms)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_plaintext_bytes_and_loads(scheme):
    port, ref = _sides(scheme)
    raw = tser.save_plaintext(port.plain)
    assert raw == jser.save_plaintext(ref.plain)
    back = tser.load_plaintext(raw, device="cpu")
    theirs = jser.load_plaintext(raw)
    _same(port.words(back.data), ref.words(theirs.data))
    assert (back.level, back.is_ntt_form, back.scale) == (
        theirs.level, theirs.is_ntt_form, theirs.scale)


KEYS = ["public", "secret", "relin", "galois", "kswitch"]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("key", KEYS)
def test_key_bytes_and_loads(scheme, key):
    port, ref = _sides(scheme)
    obj = {"public": "pk", "secret": "sk", "relin": "rlk", "galois": "gk",
           "kswitch": "ksk"}[key]
    name = {"public": "public_key", "secret": "secret_key",
            "relin": "relin_keys", "galois": "galois_keys",
            "kswitch": "kswitch_keys"}[key]
    raw = getattr(tser, f"save_{name}")(getattr(port, obj))
    assert raw == getattr(jser, f"save_{name}")(getattr(ref, obj))
    back = getattr(tser, f"load_{name}")(raw, device="cpu")
    theirs = getattr(jser, f"load_{name}")(raw)
    if hasattr(back, "keys"):
        assert sorted(back.keys) == sorted(theirs.keys)
        for i in back.keys:
            _same(interop.to_numpy(back.keys[i]), np.asarray(theirs.keys[i]))
    else:
        _same(interop.to_numpy(back.data), np.asarray(theirs.data))
    assert getattr(tser, f"save_{name}")(back) == raw


@pytest.mark.parametrize("scheme", SCHEMES)
def test_parms_bytes_and_load(scheme):
    port, ref = _sides(scheme)
    raw = tser.save_parms(port.parms)
    assert raw == jser.save_parms(ref.parms)
    assert tser.load_parms(raw) == port.parms


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("to_coeff", [False, True])
def test_fetch_ciphertexts_host(scheme, to_coeff):
    """One stacked copy (and one inverse NTT) for a list of ciphertexts."""
    port, ref = _sides(scheme)
    pcs = [port.ct, port.enc.encrypt(port.plain)]
    jcs = [ref.ct, ref.enc.encrypt(ref.plain)]
    if scheme == "bgv":
        pcs[1] = port.ev.mod_switch_to_next(pcs[1])
        jcs[1] = ref.ev.mod_switch_to_next(jcs[1])
    got = tser.fetch_ciphertexts_host(pcs, port.ctx, to_coeff)
    want = jser.fetch_ciphertexts_host(jcs, ref.ctx, to_coeff)
    assert len(got) == 2 and tser.fetch_ciphertexts_host([], port.ctx) == []
    for g, w in zip(got, want):
        _same(g, np.asarray(w))


def test_wrong_streams_raise():
    port, _ = _sides("bfv")
    ct = tser.save_ciphertext(port.ct)
    with pytest.raises(ValueError):
        tser.load_plaintext(ct)
    with pytest.raises(ValueError):
        tser.load_ciphertext(tser.save_plaintext(port.plain), port.ctx)
    with pytest.raises(ValueError):
        tser.load_relin_keys(tser.save_galois_keys(port.gk))
    with pytest.raises(ValueError):
        tser.load_parms(ct)
    with pytest.raises(ValueError, match="size 2"):
        tser.save_ciphertext(port.ct3.replace(seed=5))
