"""The whole BFV slice of troy_tpu_torch against troy_tpu, word for word.

Seeded host-sampling keygen and encryption, then multiply, relinearize,
decrypt and decode, at n = 1024 (SecurityLevel.none) and at a legal
n = 4096 configuration (the 128-bit default chain). Both packages run on
the CPU; the JAX package as its own tests run it. Then the JAX package's
keys and ciphertexts go through troy_tpu_torch.interop into the port, and
the port's outputs on them must be the JAX package's words.
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng

torch.set_num_threads(1)

SEED = 2024


def _parms(mod, name):
    if name == "n1024":
        n, q = 1024, mod.CoeffModulus.create(1024, [30, 30, 30])
    else:
        n, q = 4096, mod.CoeffModulus.bfv_default(4096)
    return mod.EncryptionParameters(
        scheme=mod.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(q), plain_modulus=mod.PlainModulus.batching(n, 20))


def _run(mod, prng, name, vals):
    """keygen -> encrypt x2 -> add/sub/negate -> multiply -> relinearize ->
    decrypt -> decode, returning every intermediate as numpy words."""
    sec = mod.SecurityLevel.none if name == "n1024" \
        else mod.SecurityLevel.tc128
    on_cpu = {"device": "cpu"} if mod is P else {}
    ctx = mod.HeContext(_parms(mod, name), sec_level=sec, **on_cpu)
    kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                          host_sampling=True)
    rlk = kg.create_relin_keys()
    be = mod.BatchEncoder(ctx)
    cts = []
    for i, v in enumerate(vals):
        enc = mod.Encryptor(ctx, secret_key=kg.secret_key,
                            seed=prng.seed_from_uint64(SEED + i),
                            host_sampling=True)
        cts.append(enc.encrypt_symmetric(be.encode(v)))
    ev = mod.Evaluator(ctx)
    dec = mod.Decryptor(ctx, kg.secret_key)
    prod = ev.multiply(*cts)
    rel = ev.relinearize(prod, rlk)
    w = lambda x: np.asarray(x) if mod is J else P.to_numpy(x)
    out = {"sk": w(kg.secret_key.data), "rlk": w(rlk.keys[2]),
           "c1": w(cts[0].data), "c2": w(cts[1].data),
           "add": w(ev.add(*cts).data), "sub": w(ev.sub(*cts).data),
           "neg": w(ev.negate(cts[0]).data),
           "prod": w(prod.data), "rel": w(rel.data),
           "plain": w(dec.decrypt(rel).data),
           "decode": be.decode(dec.decrypt(rel))}
    return out, ctx


@pytest.fixture(scope="module", params=["n1024", "n4096"])
def runs(request):
    name = request.param
    n = 1024 if name == "n1024" else 4096
    rng = np.random.default_rng(7)
    t = int(J.PlainModulus.batching(n, 20))
    vals = [rng.integers(0, t, n, dtype=np.uint64) for _ in range(2)]
    jax_out, jctx = _run(J, jprng, name, vals)
    port_out, pctx = _run(P, tprng, name, vals)
    return name, vals, t, jax_out, port_out, pctx


@pytest.mark.parametrize("stage", ["sk", "rlk", "c1", "c2"])
def test_keygen_and_encrypt_words(runs, stage):
    _, _, _, jax_out, port_out, _ = runs
    np.testing.assert_array_equal(port_out[stage], jax_out[stage])


@pytest.mark.parametrize("stage", ["add", "sub", "neg", "prod", "rel",
                                   "plain", "decode"])
def test_evaluate_and_decrypt_words(runs, stage):
    _, _, _, jax_out, port_out, _ = runs
    np.testing.assert_array_equal(port_out[stage], jax_out[stage])


def test_decrypts_to_the_product(runs):
    _, vals, t, _, port_out, _ = runs
    want = (vals[0].astype(object) * vals[1].astype(object) % t)
    np.testing.assert_array_equal(port_out["decode"],
                                  want.astype(np.uint64))


def test_jax_state_through_interop(runs):
    """The JAX package's key and ciphertext words, fed into the port."""
    _, _, _, jax_out, _, ctx = runs
    level = ctx.first_level
    sk = interop.secret_key(jax_out["sk"], "cpu")
    rlk = interop.relin_keys({2: jax_out["rlk"]}, "cpu")
    c1 = interop.ciphertext(jax_out["c1"], level, False, "cpu")
    c2 = interop.ciphertext(jax_out["c2"], level, False, "cpu")
    ev = P.Evaluator(ctx)
    prod = ev.multiply(c1, c2)
    np.testing.assert_array_equal(interop.words(prod), jax_out["prod"])
    rel = ev.relinearize(prod, rlk)
    np.testing.assert_array_equal(interop.words(rel), jax_out["rel"])
    plain = P.Decryptor(ctx, sk).decrypt(rel)
    np.testing.assert_array_equal(interop.words(plain), jax_out["plain"])
    be = P.BatchEncoder(ctx)
    pt = interop.plaintext(jax_out["plain"], "cpu")
    np.testing.assert_array_equal(be.decode(pt), jax_out["decode"])
    np.testing.assert_array_equal(interop.words(rlk)[2], jax_out["rlk"])
