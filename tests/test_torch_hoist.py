"""The hoisted Galois path of troy_tpu_torch against troy_tpu.

At n = 64 and 1024 (SecurityLevel.none), BFV in coefficient form, CKKS and
BGV in NTT form: seeded host-sampling Galois keys (steps 1, 2, -1, 4 and
the row swap) and encryptions through both packages, then
``apply_galois_many`` over four elements at the first level and at the
next, and ``rotate_many`` over steps with a key, without one (3: the NAF
path) and 0, word for word against troy_tpu's hoisted path (not against
the sequential path: the hoisted words differ from it by design,
troy_tpu/evaluator.py:504-507). Against the port's own sequential path by
decryption; coefficient-form BGV, where troy_tpu's key switch returns the
wrong domain, by decryption alone; then the argument checks and the
pre-permuted key cache. Both packages run on the CPU, the JAX package as
its own tests run it; the port's wrappers run the kernels' plain
versions.
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng

import troy_tpu_torch as P
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.utils import galois as tgalois

torch.set_num_threads(1)

SEED = 2032
NS = [64, 1024]
SCHEMES = ["bfv", "ckks", "bgv"]
STEPS = [1, 2, -1, 4, 0]                   # 0: the row swap
ROTATE = [0, 1, 3, 2, -1]                   # 3 has no key: 4 - 1
CKKS_SCALE = 2.0 ** 30


def _elts(n):
    return [tgalois.get_elt_from_step(n, s) for s in (1, 2, -1)] + [2 * n - 1]


def _context(mod, scheme, n):
    kw = {} if scheme == "ckks" else {
        "plain_modulus": mod.PlainModulus.batching(n, 20)}
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(mod.CoeffModulus.create(n, [40, 40, 40, 40])),
        **kw)
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)


def _setup(mod, prng, scheme, n, seed=SEED):
    ctx = _context(mod, scheme, n)
    kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(seed),
                          host_sampling=True)
    gk = kg.create_galois_keys(steps=STEPS)
    enc = mod.Encryptor(ctx, secret_key=kg.secret_key,
                        seed=prng.seed_from_uint64(seed + 1),
                        host_sampling=True)
    rng = np.random.default_rng(seed + n)
    if scheme == "ckks":
        encoder = mod.CKKSEncoder(ctx)
        vals = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
        ct = enc.encrypt_symmetric(encoder.encode(vals, CKKS_SCALE))
    else:
        encoder = mod.BatchEncoder(ctx)
        vals = rng.integers(0, encoder.plain_modulus, n, dtype=np.uint64)
        ct = enc.encrypt_symmetric(encoder.encode(vals))
    return ctx, kg, gk, encoder, vals, ct


def _run(mod, prng, scheme, n):
    ctx, kg, gk, encoder, vals, ct = _setup(mod, prng, scheme, n)
    ev = mod.Evaluator(ctx)
    w = (lambda x: np.asarray(x)) if mod is J else P.to_numpy
    out = {}
    elts = _elts(n)
    for e, h in zip(elts, ev.apply_galois_many(ct, elts, gk)):
        out[f"hoist{e}"] = w(h.data)
    for s, r in zip(ROTATE, ev.rotate_many(ct, ROTATE, gk)):
        out[f"rotate{s}"] = w(r.data)
    down = ev.rescale_to_next(ct) if scheme == "ckks" \
        else ev.mod_switch_to_next(ct)
    for e, h in zip(elts[:2], ev.apply_galois_many(down, elts[:2], gk)):
        out[f"next_level{e}"] = w(h.data)
    port = None
    if mod is P:
        port = {"ctx": ctx, "kg": kg, "gk": gk, "encoder": encoder,
                "vals": vals, "ct": ct, "ev": ev,
                "dec": P.Decryptor(ctx, kg.secret_key)}
    return out, port


_RUNS = {}


def runs(scheme, n):
    if (scheme, n) not in _RUNS:
        _RUNS[(scheme, n)] = (_run(J, jprng, scheme, n)[0],
                              *_run(P, tprng, scheme, n))
    return _RUNS[(scheme, n)]


def _stages(n):
    return ([f"hoist{e}" for e in _elts(n)] + [f"rotate{s}" for s in ROTATE]
            + [f"next_level{e}" for e in _elts(n)[:2]])


@pytest.mark.parametrize("scheme,n,stage", [
    (s, n, st) for s in SCHEMES for n in NS for st in _stages(n)])
def test_words(scheme, n, stage):
    jax_out, port_out, _ = runs(scheme, n)
    np.testing.assert_array_equal(port_out[stage], jax_out[stage])


def _decode(port, ct):
    return port["encoder"].decode(port["dec"].decrypt(ct))


def _same(port, got, want, what):
    if isinstance(port["encoder"], P.CKKSEncoder):
        assert np.abs(got - want).max() < 1e-3, what
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("scheme,n", [(s, n) for s in SCHEMES for n in NS])
def test_hoisted_decrypts_as_sequential(scheme, n):
    _, _, port = runs(scheme, n)
    ev, ct, gk = port["ev"], port["ct"], port["gk"]
    for e, h in zip(_elts(n), ev.apply_galois_many(ct, _elts(n), gk)):
        _same(port, _decode(port, h), _decode(port, ev.apply_galois(ct, e,
                                                                    gk)),
              f"element {e}")
    rotate = ev.rotate_vector if scheme == "ckks" else ev.rotate_rows
    for s, r in zip(ROTATE, ev.rotate_many(ct, ROTATE, gk)):
        want = ct if s == 0 else rotate(ct, s, gk)
        _same(port, _decode(port, r), _decode(port, want), f"step {s}")


def _rows(vals, n, step):
    return np.roll(vals.reshape(2, n // 2), -step, axis=1).reshape(-1)


@pytest.mark.parametrize("n", NS)
def test_bgv_coefficient_form_galois(n):
    """Coefficient-form BGV: the key switch divides in the coefficient
    domain (kernel K''), and every Galois op decrypts to the rotated
    slots; troy_tpu's result is in the wrong domain there."""
    _, _, port = runs("bgv", n)
    ev, gk, vals = port["ev"], port["gk"], port["vals"]
    ct = ev.transform_from_ntt(port["ct"])
    swapped = vals.reshape(2, n // 2)[::-1].reshape(-1)
    checks = {
        "apply_galois": (ev.apply_galois(ct, _elts(n)[0], gk),
                         _rows(vals, n, 1)),
        "rotate_rows(3)": (ev.rotate_rows(ct, 3, gk), _rows(vals, n, 3)),
        "rotate_columns": (ev.rotate_columns(ct, gk), swapped),
    }
    for s, r in zip(ROTATE, ev.rotate_many(ct, ROTATE, gk)):
        checks[f"rotate_many {s}"] = (r, _rows(vals, n, s))
    for e, h in zip(_elts(n), ev.apply_galois_many(ct, _elts(n), gk)):
        checks[f"apply_galois_many {e}"] = (h, _decode(
            port, ev.apply_galois(port["ct"], e, gk)))
    for what, (got, want) in checks.items():
        assert not got.is_ntt_form, what
        np.testing.assert_array_equal(_decode(port, got), want, err_msg=what)


def test_rotate_many_step_zero_and_naf():
    _, _, port = runs("bfv", 64)
    ev, ct, gk, vals = port["ev"], port["ct"], port["gk"], port["vals"]
    out = ev.rotate_many(ct, [0, 3, 0], gk)
    assert out[0] is not ct and out[2] is not ct and out[0] is not out[2]
    assert torch.equal(out[0].data, ct.data)
    np.testing.assert_array_equal(_decode(port, out[1]), _rows(vals, 64, 3))
    with pytest.raises(ValueError, match="not present"):
        ev.rotate_many(ct, [1, 5], P.GaloisKeys(keys={
            e: gk.keys[e] for e in _elts(64)[:1]}))


def test_apply_galois_many_checks():
    """Size 2 only; no elements give []; a missing key raises before any
    pre-permuted key is made."""
    _, _, port = runs("bfv", 64)
    ctx, ct, gk = port["ctx"], port["ct"], port["gk"]
    ev = P.Evaluator(ctx)
    with pytest.raises(ValueError, match="size-2"):
        ev.apply_galois_many(ct.replace(data=torch.cat([ct.data,
                                                        ct.data[:1]])),
                             _elts(64), gk)
    assert ev.apply_galois_many(ct, [], gk) == []
    with pytest.raises(ValueError, match="not present"):
        ev.apply_galois_many(ct, _elts(64)[:2] + [5], gk)
    assert not ev._pp_keys and not ev._pp_stacks
    with pytest.raises(ValueError, match="NTT form"):
        ckks = runs("ckks", 64)[2]
        ckks["ev"].apply_galois_many(
            ckks["ev"].transform_from_ntt(ckks["ct"]), _elts(64), ckks["gk"])


def test_prepermuted_keys_per_key_set():
    """Two key sets sharing an element each get their own cache entry and
    each decrypts under its own secret key; the caches stay bounded."""
    ctx, kg1, gk1, be, vals, ct1 = _setup(P, tprng, "bfv", 64, SEED + 7)
    kg2 = P.KeyGenerator(ctx, seed=tprng.seed_from_uint64(SEED + 9),
                         host_sampling=True)
    gk2 = kg2.create_galois_keys(steps=[1, 2])
    ct2 = P.Encryptor(ctx, secret_key=kg2.secret_key,
                      seed=tprng.seed_from_uint64(SEED + 10),
                      host_sampling=True).encrypt_symmetric(be.encode(vals))
    ev = P.Evaluator(ctx)
    elts = _elts(64)[:2]                     # steps 1 and 2
    for kg, gk, ct in ((kg1, gk1, ct1), (kg2, gk2, ct2)):
        dec = P.Decryptor(ctx, kg.secret_key)
        for step, got in zip((1, 2), ev.apply_galois_many(ct, elts, gk)):
            np.testing.assert_array_equal(be.decode(dec.decrypt(got)),
                                          _rows(vals, 64, step))
    assert len(ev._pp_keys) == 4 and len(ev._pp_stacks) == 2
    ev.PP_KEY_CACHE_MAX, ev.PP_STACK_CACHE_MAX = 2, 1
    ev.apply_galois_many(ct1, _elts(64), gk1)
    assert len(ev._pp_keys) == 2 and len(ev._pp_stacks) == 1


def test_one_element_is_apply_galois():
    """Below HOIST_MIN_M elements apply_galois_many is apply_galois: one
    hoisted element costs more than it saves on the card."""
    _, _, port = runs("ckks", 64)
    ev, ct, gk = port["ev"], port["ct"], port["gk"]
    assert ev.HOIST_MIN_M == 2
    for e in _elts(64):
        got = ev.apply_galois_many(ct, [e], gk)[0]
        assert torch.equal(got.data, ev.apply_galois(ct, e, gk).data)
