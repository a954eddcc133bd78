"""The BFV mod switch and the noise budget of troy_tpu_torch against troy_tpu.

At n = 1024 with four 30-bit primes (SecurityLevel.none; data levels of
3, 2 and 1 limbs) and at the n = 4096 default chain: a relinearized product
switched one level down (mod_switch_to_next) and to the last level
(mod_switch_to), fresh ciphertexts switched down and multiplied and
relinearized there, each decrypted at its level, and the invariant noise
budget of each, word for word and bit for bit against the JAX package. Both
packages run on the CPU; the port's wrappers run the kernels' plain
versions.
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng

import troy_tpu_torch as P
from troy_tpu_torch import prng as tprng

torch.set_num_threads(1)

SEED = 2024


def _context(mod, name):
    if name == "n1024":
        n, q = 1024, mod.CoeffModulus.create(1024, [30, 30, 30, 30])
        sec = mod.SecurityLevel.none
    else:
        n, q = 4096, mod.CoeffModulus.bfv_default(4096)
        sec = mod.SecurityLevel.tc128
    parms = mod.EncryptionParameters(
        scheme=mod.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(q), plain_modulus=mod.PlainModulus.batching(n, 20))
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=sec, **on_cpu)


def _run(mod, prng, name, vals):
    ctx = _context(mod, name)
    kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED),
                          host_sampling=True)
    rlk = kg.create_relin_keys()
    be = mod.BatchEncoder(ctx)
    cts = [mod.Encryptor(ctx, secret_key=kg.secret_key,
                         seed=prng.seed_from_uint64(SEED + i),
                         host_sampling=True).encrypt_symmetric(be.encode(v))
           for i, v in enumerate(vals)]
    ev = mod.Evaluator(ctx)
    dec = mod.Decryptor(ctx, kg.secret_key)
    rel = ev.relinearize(ev.multiply(*cts), rlk)
    down = [ev.mod_switch_to_next(c) for c in cts]
    prod_down = ev.multiply(*down)
    results = {
        "rel": rel,
        "ms": ev.mod_switch_to_next(rel),
        "ms_last": ev.mod_switch_to(rel, ctx.last_level),
        "c1_down": down[0],
        "prod_down": prod_down,
        "rel_down": ev.relinearize(prod_down, rlk),
    }
    w = (lambda x: np.asarray(x)) if mod is J else P.to_numpy
    out = {tag: w(ct.data) for tag, ct in results.items()}
    out["levels"] = {tag: ct.level for tag, ct in results.items()}
    out["plain"] = {tag: w(dec.decrypt(ct).data)
                    for tag, ct in results.items() if ct.size == 2}
    out["slots"] = {tag: be.decode(dec.decrypt(ct))
                    for tag, ct in results.items() if ct.size == 2}
    out["budget"] = {tag: dec.invariant_noise_budget(ct)
                     for tag, ct in results.items()}
    return out, (ctx, ev, results)


@pytest.fixture(scope="module", params=["n1024", "n4096"])
def runs(request):
    name = request.param
    n = 1024 if name == "n1024" else 4096
    rng = np.random.default_rng(13)
    t = int(J.PlainModulus.batching(n, 20))
    vals = [rng.integers(0, t, n, dtype=np.uint64) for _ in range(2)]
    jax_out, _ = _run(J, jprng, name, vals)
    port_out, port = _run(P, tprng, name, vals)
    return vals, t, jax_out, port_out, port


@pytest.mark.parametrize("stage", ["rel", "ms", "ms_last", "c1_down",
                                   "prod_down", "rel_down"])
def test_mod_switch_words(runs, stage):
    _, _, jax_out, port_out, _ = runs
    assert port_out["levels"][stage] == jax_out["levels"][stage]
    np.testing.assert_array_equal(port_out[stage], jax_out[stage])


def test_decrypt_at_lower_levels(runs):
    vals, t, jax_out, port_out, (ctx, _, _) = runs
    assert port_out["levels"]["ms_last"] == ctx.last_level
    for tag, words in jax_out["plain"].items():
        np.testing.assert_array_equal(port_out["plain"][tag], words,
                                      err_msg=tag)
    prod = (vals[0].astype(object) * vals[1].astype(object) % t)
    # a product made at the last level of the n = 4096 chain (one 36-bit
    # prime) has no budget left: it decrypts to noise, in both packages
    for tag in ("rel", "ms", "ms_last", "rel_down"):
        if port_out["budget"][tag] > 0:
            np.testing.assert_array_equal(port_out["slots"][tag],
                                          prod.astype(np.uint64), err_msg=tag)
    assert port_out["budget"]["ms"] > 0
    np.testing.assert_array_equal(port_out["slots"]["c1_down"], vals[0])


def test_invariant_noise_budget(runs):
    _, _, jax_out, port_out, _ = runs
    assert port_out["budget"] == jax_out["budget"]
    assert port_out["budget"]["rel"] > 0


def test_switching_past_the_last_level_raises(runs):
    _, _, _, _, (ctx, ev, results) = runs
    with pytest.raises(ValueError, match="last level"):
        ev.mod_switch_to_next(results["ms_last"])
    with pytest.raises(ValueError, match="higher level"):
        ev.mod_switch_to(results["ms"], ctx.first_level)
