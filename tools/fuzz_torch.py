"""Seeded random op sequences through troy_tpu_torch, on either device,
checked against a plaintext model after every step.

The sequences of tests/test_differential_fuzz.py (the JAX package's),
with its seeds, parameter sets, op lists and slot models: BFV and BGV at
n = 64, q = {40,40,40}, a 16-bit batching t (``bfv_bgv_sequence``); CKKS
at n = 64, q = {50,40,40,50}, scale 2^40 (``ckks_sequence``); BFV on kernel
J's route at n = 2048 (``mxu_sequence``). After every step the decryption
must decode to the model, and ``decrypt_many`` of the running ciphertext
and a copy must give ``decrypt``'s words. Beyond them: BFV with a
coefficient (polynomial) model at t = 2^41 over {60,60,60} and at a
non-batching t (``polynomial_sequence``), and the ops the sequences leave
out (``other_ops``): public-key encrypt, multiply_many, exponentiate,
field_trace, rescale_to and mod_switch_plain_to. Each function raises
AssertionError at the first step that diverges and returns the number of
steps it checked. tests/test_torch_differential_fuzz.py runs them on the
CPU, chip_smoke.py's phase 36 on the card. Imports torch, numpy and
troy_tpu_torch, never JAX.
"""

from __future__ import annotations

import numpy as np

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as rnd
from troy_tpu_torch.utils import galois as galois_util

N = 64
HALF = N // 2


def build(scheme, q_bits, t=None, seed=1, n=N, device="cpu", **kw):
    """A context and a key generator seeded as the JAX suite seeds its."""
    kwargs = {} if t is None else {"plain_modulus": t}
    parms = P.EncryptionParameters(
        scheme=scheme, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, list(q_bits))),
        **kwargs)
    ctx = P.HeContext(parms, sec_level=P.SecurityLevel.none, device=device,
                      **kw)
    return ctx, P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(seed))


def same_as_decrypt_many(dec, ct, what: str) -> P.Plaintext:
    """decrypt(ct), after checking that decrypt_many of ct and a copy of it
    gives its words twice."""
    one = dec.decrypt(ct)
    want = interop.words(one)
    for got in dec.decrypt_many([ct, ct.replace(data=ct.data.clone())]):
        np.testing.assert_array_equal(interop.words(got), want,
                                      err_msg=f"{what}: decrypt_many")
    return one


def _rot_rows_model(v, steps, half=HALF):
    return np.concatenate([np.roll(v[:half], -steps),
                           np.roll(v[half:], -steps)])


def bfv_bgv_sequence(scheme, fuzz_seed: int, device: str = "cpu") -> int:
    """tests/test_differential_fuzz.py test_bfv_bgv_random_sequences."""
    ctx, kg = build(scheme, [40, 40, 40], P.PlainModulus.batching(N, 16),
                    seed=101 + fuzz_seed, device=device)
    t = int(ctx.first_context_data.plain_modulus)
    rlk = kg.create_relin_keys()
    # rotate_columns needs the column swap's element 2N-1 on top of the
    # steps' elements (galois.h:68 getEltFromStep)
    glk = kg.create_galois_keys(
        elts=list(galois_util.get_elts_from_steps(N, [1, 2, 3, -1, -2, -3]))
        + [2 * N - 1])
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(501 + fuzz_seed))
    dec = P.Decryptor(ctx, kg.secret_key)
    be = P.BatchEncoder(ctx)
    ev = P.Evaluator(ctx)
    rng = np.random.default_rng(900 + fuzz_seed)

    a = rng.integers(0, t, N, dtype=np.uint64)
    b = rng.integers(0, t, N, dtype=np.uint64)
    ct = enc.encrypt_symmetric(be.encode(a))
    ct_other = enc.encrypt_symmetric(be.encode(b))
    model = a.astype(object)
    model_other = b.astype(object)
    mults_left = 2   # the noise budget at N = 64 with 2 data primes
    checked = 0

    ops = ["add", "sub", "negate", "add_plain", "sub_plain",
           "multiply_plain", "multiply", "square",
           "rotate_rows", "rotate_columns", "mod_switch"]
    for step_i in range(12):
        op = ops[rng.integers(len(ops))]
        if op == "add":
            if ct_other.level != ct.level:
                ct_other = ev.mod_switch_to(ct_other, ct.level)
            ct = ev.add(ct, ct_other)
            model = (model + model_other) % t
        elif op == "sub":
            if ct_other.level != ct.level:
                ct_other = ev.mod_switch_to(ct_other, ct.level)
            ct = ev.sub(ct, ct_other)
            model = (model - model_other) % t
        elif op == "negate":
            ct = ev.negate(ct)
            model = (-model) % t
        elif op in ("add_plain", "sub_plain", "multiply_plain"):
            p = rng.integers(0, t, N, dtype=np.uint64)
            pt = be.encode(p)
            if op == "add_plain":
                ct = ev.add_plain(ct, pt)
                model = (model + p.astype(object)) % t
            elif op == "sub_plain":
                ct = ev.sub_plain(ct, pt)
                model = (model - p.astype(object)) % t
            else:
                ct = ev.multiply_plain(ct, pt)
                model = (model * p.astype(object)) % t
        elif op == "multiply" and mults_left > 0:
            if ct_other.level != ct.level:
                ct_other = ev.mod_switch_to(ct_other, ct.level)
            ct = ev.relinearize(ev.multiply(ct, ct_other), rlk)
            model = (model * model_other) % t
            mults_left -= 1
        elif op == "square" and mults_left > 0:
            ct = ev.relinearize(ev.square(ct), rlk)
            model = (model * model) % t
            mults_left -= 1
        elif op == "rotate_rows":
            s = int(rng.integers(1, 4)) * int(rng.choice([-1, 1]))
            ct = ev.rotate_rows(ct, s, glk)
            model = _rot_rows_model(model, s)
        elif op == "rotate_columns":
            ct = ev.rotate_columns(ct, glk)
            model = np.concatenate([model[HALF:], model[:HALF]])
        elif op == "mod_switch" and ct.level + 1 < len(ctx.chain):
            ct = ev.mod_switch_to_next(ct)
            mults_left = 0   # too little room left for a product
        # a positive invariant noise budget guarantees exact decryption;
        # random products at N = 64 may exhaust it, which is no fault
        if dec.invariant_noise_budget(ct) <= 0:
            break
        what = f"{scheme.name} fuzz seed {fuzz_seed} step {step_i} ({op})"
        got = be.decode(same_as_decrypt_many(dec, ct, what)).astype(object)
        assert np.array_equal(got, model % t), f"{what}: diverged"
        checked += 1
    return checked


def ckks_sequence(fuzz_seed: int, device: str = "cpu") -> int:
    """tests/test_differential_fuzz.py test_ckks_random_sequences: a 40-bit
    scale over 40-bit middle primes, so ct and ct_other stay composable."""
    scale = float(1 << 40)
    ctx, kg = build(P.SchemeType.ckks, [50, 40, 40, 50], seed=77 + fuzz_seed,
                    device=device)
    rlk = kg.create_relin_keys()
    # complex_conjugate needs element 2N-1 beside the rotations'
    glk = kg.create_galois_keys(
        elts=list(galois_util.get_elts_from_steps(N, [1, 2, -1, -2]))
        + [2 * N - 1])
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(601 + fuzz_seed))
    dec = P.Decryptor(ctx, kg.secret_key)
    encd = P.CKKSEncoder(ctx)
    ev = P.Evaluator(ctx)
    rng = np.random.default_rng(300 + fuzz_seed)

    a = rng.uniform(-1, 1, HALF) + 1j * rng.uniform(-1, 1, HALF)
    b = rng.uniform(-1, 1, HALF) + 1j * rng.uniform(-1, 1, HALF)
    ct = enc.encrypt_symmetric(encd.encode(a, scale))
    ct_other = enc.encrypt_symmetric(encd.encode(b, scale))
    model, model_other = a.copy(), b.copy()
    mults_left = 2   # 3 data primes: 2 rescales
    checked = 0

    ops = ["add", "sub", "negate", "rotate", "conjugate", "multiply",
           "multiply_plain", "add_plain"]
    for step_i in range(10):
        op = ops[rng.integers(len(ops))]
        if op == "add":
            if ct_other.level != ct.level:
                break   # the operand is spent by earlier rescales
            ct = ev.add(ct, ct_other)
            model = model + model_other
        elif op == "sub":
            if ct_other.level != ct.level:
                break
            ct = ev.sub(ct, ct_other)
            model = model - model_other
        elif op == "negate":
            ct = ev.negate(ct)
            model = -model
        elif op == "rotate":
            s = int(rng.choice([-2, -1, 1, 2]))
            ct = ev.rotate_vector(ct, s, glk)
            model = np.roll(model, -s)
        elif op == "conjugate":
            ct = ev.complex_conjugate(ct, glk)
            model = np.conj(model)
        elif op == "multiply" and mults_left > 0:
            ct = ev.rescale_to_next(ev.relinearize(
                ev.multiply(ct, ct_other), rlk))
            model = model * model_other
            mults_left -= 1
            # the companion again at the drifted scale and level, so later
            # adds stay scale-exact
            ct_other = enc.encrypt_symmetric(
                encd.encode(model_other, ct.scale, level=ct.level))
        elif op == "multiply_plain" and mults_left > 0:
            p = rng.uniform(-1, 1, HALF)
            pt = encd.encode(p, scale, level=ct.level)
            ct = ev.rescale_to_next(ev.multiply_plain(ct, pt))
            model = model * p
            mults_left -= 1
            ct_other = enc.encrypt_symmetric(
                encd.encode(model_other, ct.scale, level=ct.level))
        elif op == "add_plain":
            p = rng.uniform(-1, 1, HALF)
            pt = encd.encode(p, ct.scale, level=ct.level)
            ct = ev.add_plain(ct, pt)
            model = model + p
        what = f"ckks fuzz seed {fuzz_seed} step {step_i} ({op})"
        got = encd.decode(same_as_decrypt_many(dec, ct, what))
        assert np.allclose(got, model, atol=1e-3), \
            f"{what}: max err {np.abs(got - model).max()}"
        checked += 1
    return checked


def mxu_sequence(device: str = "cpu") -> int:
    """tests/test_differential_fuzz.py test_bfv_mxu_path_random_sequence:
    n = 2048 with every NTT on kernel J (use_mxu=True)."""
    n = 2048
    ctx, kg = build(P.SchemeType.bfv, [50, 40, 50],
                    P.PlainModulus.batching(n, 18), seed=2048, n=n,
                    device=device, use_mxu=True)
    assert ctx.first_context_data.ntt.mxu is not None
    t = int(ctx.first_context_data.plain_modulus)
    rlk = kg.create_relin_keys()
    glk = kg.create_galois_keys(steps=[1, -1])
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(2049))
    dec = P.Decryptor(ctx, kg.secret_key)
    be = P.BatchEncoder(ctx)
    ev = P.Evaluator(ctx)
    rng = np.random.default_rng(77)
    half = n // 2

    a = rng.integers(0, t, n, dtype=np.uint64)
    ct = enc.encrypt_symmetric(be.encode(a))
    model = a.astype(object)
    mults_left = 1
    checked = 0
    for step_i in range(6):
        op = ["add_plain", "multiply_plain", "square",
              "rotate_rows", "negate"][rng.integers(5)]
        p = rng.integers(0, t, n, dtype=np.uint64)
        if op == "add_plain":
            ct = ev.add_plain(ct, be.encode(p))
            model = (model + p.astype(object)) % t
        elif op == "multiply_plain":
            ct = ev.multiply_plain(ct, be.encode(p))
            model = (model * p.astype(object)) % t
        elif op == "square" and mults_left > 0:
            ct = ev.relinearize(ev.square(ct), rlk)
            model = (model * model) % t
            mults_left -= 1
        elif op == "rotate_rows":
            s = int(rng.choice([-1, 1]))
            ct = ev.rotate_rows(ct, s, glk)
            model = _rot_rows_model(model, s, half)
        elif op == "negate":
            ct = ev.negate(ct)
            model = (-model) % t
        if dec.invariant_noise_budget(ct) <= 0:
            break
        what = f"mxu fuzz step {step_i} ({op})"
        got = be.decode(same_as_decrypt_many(dec, ct, what)).astype(object)
        assert np.array_equal(got, model % t), f"{what}: diverged"
        checked += 1
    return checked


# --------------------------------------------------------------------------
# beyond the JAX suite
# --------------------------------------------------------------------------

def negacyclic_product(a, b, t: int) -> np.ndarray:
    """a b mod (x^n + 1, t) in Python integers."""
    n = len(a)
    out = [0] * n
    for i, ai in enumerate(int(x) for x in a):
        if ai:
            for j, bj in enumerate(int(x) for x in b):
                if i + j < n:
                    out[i + j] += ai * bj
                else:
                    out[i + j - n] -= ai * bj
    return np.array([v % t for v in out], dtype=object)


def polynomial_sequence(t: int, q_bits, fuzz_seed: int,
                        device: str = "cpu") -> int:
    """BFV at a t the slots cannot batch (a power of two, or a prime not
    1 mod 2n): plaintexts are coefficient vectors (encode_polynomial), the
    model their sums and negacyclic products mod t, over add, sub, negate,
    the plain ops, multiply and square with relinearize, and the mod
    switch."""
    ctx, kg = build(P.SchemeType.bfv, q_bits, P.Modulus(t),
                    seed=1100 + fuzz_seed, device=device)
    rlk = kg.create_relin_keys()
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(1200 + fuzz_seed))
    dec = P.Decryptor(ctx, kg.secret_key)
    be = P.BatchEncoder(ctx)
    ev = P.Evaluator(ctx)
    rng = np.random.default_rng(1300 + fuzz_seed)

    def draw():
        return rng.integers(0, t, N, dtype=np.uint64)

    a, b = draw(), draw()
    ct = enc.encrypt_symmetric(be.encode_polynomial(a))
    ct_other = enc.encrypt_symmetric(be.encode_polynomial(b))
    model, model_other = a.astype(object), b.astype(object)
    mults_left = 1
    checked = 0
    ops = ["add", "sub", "negate", "add_plain", "sub_plain",
           "multiply_plain", "multiply", "square", "mod_switch"]
    for step_i in range(10):
        op = ops[rng.integers(len(ops))]
        if op in ("add", "sub", "multiply") and ct_other.level != ct.level:
            ct_other = ev.mod_switch_to(ct_other, ct.level)
        if op == "add":
            ct = ev.add(ct, ct_other)
            model = (model + model_other) % t
        elif op == "sub":
            ct = ev.sub(ct, ct_other)
            model = (model - model_other) % t
        elif op == "negate":
            ct = ev.negate(ct)
            model = (-model) % t
        elif op in ("add_plain", "sub_plain"):
            p = draw()
            pt = be.encode_polynomial(p)
            if op == "add_plain":
                ct = ev.add_plain(ct, pt)
                model = (model + p.astype(object)) % t
            else:
                ct = ev.sub_plain(ct, pt)
                model = (model - p.astype(object)) % t
        elif op == "multiply_plain":
            # two small terms keep the product's noise small
            p = np.zeros(N, dtype=np.uint64)
            p[rng.integers(0, N, 2)] = rng.integers(1, 256, 2,
                                                    dtype=np.uint64)
            ct = ev.multiply_plain(ct, be.encode_polynomial(p))
            model = negacyclic_product(model, p, t)
        elif op == "multiply" and mults_left > 0:
            ct = ev.relinearize(ev.multiply(ct, ct_other), rlk)
            model = negacyclic_product(model, model_other, t)
            mults_left -= 1
        elif op == "square" and mults_left > 0:
            ct = ev.relinearize(ev.square(ct), rlk)
            model = negacyclic_product(model, model, t)
            mults_left -= 1
        elif op == "mod_switch" and ct.level + 1 < len(ctx.chain):
            ct = ev.mod_switch_to_next(ct)
            mults_left = 0
        if dec.invariant_noise_budget(ct) <= 0:
            break
        what = f"t = {t} fuzz seed {fuzz_seed} step {step_i} ({op})"
        got = be.decode_polynomial(same_as_decrypt_many(dec, ct, what))
        assert np.array_equal(got.astype(object) % t, model % t), \
            f"{what}: diverged"
        checked += 1
    return checked


def other_ops(scheme, device: str = "cpu") -> int:
    """The ops the sequences leave out, each checked by decryption and
    decrypt_many. BFV and BGV (q = {40,40,40}, a 17-bit batching t):
    public-key encrypt, multiply_many of three, exponentiate(2) and
    field_trace to a subfield of degree 8 on coefficient plaintexts. CKKS
    (q = {50,40,40,50}, scale 2^40): public-key encrypt, multiply_many of
    two, exponentiate(2), a product at scale 2^120 brought down two levels
    by rescale_to, and a plaintext at the first level added after
    mod_switch_plain_to."""
    checked = 0
    if scheme == P.SchemeType.ckks:
        scale = float(1 << 40)
        ctx, kg = build(scheme, [50, 40, 40, 50], seed=1400, device=device)
        rlk = kg.create_relin_keys()
        enc = P.Encryptor(ctx, kg.create_public_key(), kg.secret_key,
                          rnd.seed_from_uint64(1401))
        dec = P.Decryptor(ctx, kg.secret_key)
        ce = P.CKKSEncoder(ctx)
        ev = P.Evaluator(ctx)
        rng = np.random.default_rng(1402)
        a = rng.uniform(-1, 1, HALF) + 1j * rng.uniform(-1, 1, HALF)
        b = rng.uniform(-1, 1, HALF)
        ca = enc.encrypt(ce.encode(a, scale))
        cb = enc.encrypt(ce.encode(b, scale))

        def check(ct, want, what):
            got = ce.decode(same_as_decrypt_many(dec, ct, f"ckks {what}"))
            assert np.allclose(got, want, atol=1e-3), \
                f"ckks {what}: max err {np.abs(got - want).max()}"
            return 1

        checked += check(ca, a, "public-key encrypt")
        checked += check(ev.rescale_to_next(ev.multiply_many([ca, cb], rlk)),
                         a * b, "multiply_many")
        checked += check(ev.rescale_to_next(ev.exponentiate(ca, 2, rlk)),
                         a * a, "exponentiate(2)")
        deep = ev.multiply_plain(ev.relinearize(ev.multiply(ca, cb), rlk),
                                 ce.encode(b, scale))
        down = ev.rescale_to(deep, ctx.first_level + 2)
        assert down.level == ctx.first_level + 2
        checked += check(down, a * b * b, "rescale_to two levels down")
        p = ce.encode(b, down.scale)
        checked += check(ev.add_plain(down, ev.mod_switch_plain_to(
            p, down.level)), a * b * b + b, "mod_switch_plain_to")
        return checked

    t_bits = 17
    ctx, kg = build(scheme, [40, 40, 40], P.PlainModulus.batching(N, t_bits),
                    seed=1500 + int(scheme), device=device)
    t = int(ctx.first_context_data.plain_modulus)
    rlk = kg.create_relin_keys()
    enc = P.Encryptor(ctx, kg.create_public_key(), kg.secret_key,
                      rnd.seed_from_uint64(1501))
    dec = P.Decryptor(ctx, kg.secret_key)
    be = P.BatchEncoder(ctx)
    ev = P.Evaluator(ctx)
    rng = np.random.default_rng(1502)
    vals = [rng.integers(0, t, N, dtype=np.uint64) for _ in range(3)]
    cts = [enc.encrypt(be.encode(v)) for v in vals]

    def check(ct, want, what):
        got = be.decode(same_as_decrypt_many(dec, ct, f"{scheme.name} "
                                             f"{what}")).astype(object)
        assert np.array_equal(got, want % t), f"{scheme.name} {what}"
        return 1

    obj = [v.astype(object) for v in vals]
    checked += check(cts[0], obj[0], "public-key encrypt")
    checked += check(ev.multiply_many(cts, rlk), obj[0] * obj[1] * obj[2],
                     "multiply_many of three")
    checked += check(ev.exponentiate(cts[1], 2, rlk), obj[1] * obj[1],
                     "exponentiate(2)")
    # the trace to degree 2^logn keeps coefficients at multiples of
    # n / 2^logn, times n / 2^logn, and zeroes the rest
    logn = 3
    step = N >> logn
    c = rng.integers(0, t, N, dtype=np.uint64)
    traced = ev.field_trace(enc.encrypt(be.encode_polynomial(c)),
                            kg.create_automorphism_keys(), logn)
    want = np.zeros(N, dtype=object)
    want[::step] = c[::step].astype(object) * step % t
    got = be.decode_polynomial(same_as_decrypt_many(dec, traced, "trace"))
    assert np.array_equal(got.astype(object) % t, want), \
        f"{scheme.name} field_trace"
    return checked + 1
