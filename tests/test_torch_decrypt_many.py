"""Decryptor.decrypt_many of troy_tpu_torch against troy_tpu's on the CPU.

BFV and BGV at n = 64, CKKS at n = 256, q = {40,40,40,40}, t =
PlainModulus.batching(64, 20): seeded host-sampling keys and seeded
default-path encryptions in both packages. Batches of 4 size-2
ciphertexts (BFV in coefficient form and after transform_to_ntt, BGV with
a correction factor other than 1 after a mod switch, CKKS at two levels)
and of size-3 products (s^2 from the cached powers) decrypt to
troy_tpu's words (tolerance 0), to the port's own one-by-one decrypt, and
to the messages; CKKS keeps each ciphertext's level and scale. The
plaintexts hold host (CPU) data; one ciphertext goes to decrypt. Mixed
sizes, levels, forms and correction factors raise ValueError.
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng

torch.set_num_threads(2)

SEED = 6262
SCALE = 2.0 ** 30
BATCH = 4


class Side:
    def __init__(self, mod, scheme):
        self.port = mod is P
        self.ckks = scheme == "ckks"
        n = 256 if self.ckks else 64
        self.n = n
        prng = tprng if self.port else jprng
        extra = {} if self.ckks else {
            "plain_modulus": mod.PlainModulus.batching(n, 20)}
        parms = mod.EncryptionParameters(
            scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
            coeff_modulus=tuple(mod.CoeffModulus.create(n,
                                                        [40, 40, 40, 40])),
            **extra)
        on_cpu = {"device": "cpu"} if self.port else {}
        ctx = mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                            **on_cpu)
        kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                              host_sampling=True)
        enc = mod.Encryptor(ctx, secret_key=kg.secret_key,
                            seed=prng.seed_from_uint64(SEED + 1))
        self.dec = mod.Decryptor(ctx, kg.secret_key)
        self.ev = mod.Evaluator(ctx)
        rng = np.random.default_rng(SEED)
        if self.ckks:
            self.encoder = mod.CKKSEncoder(ctx)
            self.msgs = [rng.uniform(-1, 1, n // 4) for _ in range(BATCH)]
            plains = [self.encoder.encode_polynomial(m, SCALE)
                      for m in self.msgs]
        else:
            self.encoder = mod.BatchEncoder(ctx)
            self.t = self.encoder.plain_modulus
            self.msgs = [rng.integers(0, self.t, n, dtype=np.uint64)
                         for _ in range(BATCH)]
            plains = [self.encoder.encode_polynomial(m) for m in self.msgs]
        self.cts = enc.encrypt_symmetric_many(plains)
        ev = self.ev
        self.batches = {"fresh": self.cts,
                        "size3": [ev.multiply(c, c) for c in self.cts]}
        if scheme == "bfv":
            self.batches["ntt"] = [ev.transform_to_ntt(c) for c in self.cts]
        else:
            self.batches["next_level"] = [ev.mod_switch_to_next(c)
                                          for c in self.cts]

    def words(self, x) -> np.ndarray:
        return interop.to_numpy(x) if self.port else np.asarray(x)


_SIDES = {}


def _sides(scheme):
    if scheme not in _SIDES:
        _SIDES[scheme] = Side(P, scheme), Side(J, scheme)
    return _SIDES[scheme]


CASES = [("bfv", "fresh"), ("bfv", "ntt"), ("bfv", "size3"),
         ("bgv", "fresh"), ("bgv", "next_level"), ("bgv", "size3"),
         ("ckks", "fresh"), ("ckks", "next_level"), ("ckks", "size3")]


@pytest.mark.parametrize("scheme,batch", CASES)
def test_decrypt_many_matches_troy_tpu(scheme, batch):
    port, ref = _sides(scheme)
    cts = port.batches[batch]
    if scheme == "bgv" and batch == "next_level":
        assert cts[0].correction_factor != 1
    got = port.dec.decrypt_many(cts)
    want = ref.dec.decrypt_many(ref.batches[batch])
    one = [port.dec.decrypt(c) for c in cts]
    assert len(got) == len(cts)
    for g, w, o, c in zip(got, want, one, cts):
        assert g.data.device.type == "cpu"
        words = port.words(g.data)
        assert int((words != ref.words(w.data)).sum()) == 0
        assert np.array_equal(words, port.words(o.data))
        assert (g.level, g.is_ntt_form, g.scale) == (w.level, w.is_ntt_form,
                                                     w.scale)
        if scheme == "ckks":
            assert (g.level, g.scale) == (c.level, c.scale)
    for g, msg in zip(got, port.msgs):
        if scheme == "ckks":
            dec = port.encoder.decode_polynomial(g)
            if batch == "size3":
                continue          # the square of a polynomial
            np.testing.assert_allclose(dec[:len(msg)], msg, atol=1e-6)
        elif batch != "size3":
            np.testing.assert_array_equal(port.encoder.decode_polynomial(g),
                                          msg)


@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_decrypt_many_edges(scheme):
    port, _ = _sides(scheme)
    assert port.dec.decrypt_many([]) == []
    one = port.dec.decrypt_many(port.cts[:1])
    assert len(one) == 1
    assert np.array_equal(port.words(one[0].data),
                          port.words(port.dec.decrypt(port.cts[0]).data))


@pytest.mark.parametrize("mix", ["size", "level", "form", "factor"])
def test_decrypt_many_refuses_mixed_batches(mix):
    scheme = "bfv" if mix == "form" else "bgv"
    port, _ = _sides(scheme)
    a = port.cts[0]
    if mix == "size":
        b = port.batches["size3"][1]
    elif mix == "level":
        b = port.ev.mod_switch_to_next(port.cts[1])
    elif mix == "form":
        b = port.batches["ntt"][1]
    else:
        b = port.cts[1].replace(correction_factor=3)
    with pytest.raises(ValueError, match="uniform"):
        port.dec.decrypt_many([a, b])
