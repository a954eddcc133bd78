"""The multi-device regimes of troy_tpu_torch.parallel (R) against
troy_tpu.parallel.sharding, on the CPU with the gloo backend.

The same seeded keys and ciphertexts (made by troy_tpu at n = 64) go
through troy_tpu's runners on the conftest's 8-device CPU mesh (a mesh
whose size divides the sharded axis; where troy_tpu cannot split an axis
unevenly, through its unsharded evaluator, which its own tests hold its
runners to) and through the port's runners in 2 and 4 spawned ranks
(``sharding.spawn`` of ``spmd.run_jobs``, one spawn per rank count for
every job). The port's gathered output must be word-equal (tolerance 0) to
troy_tpu's and to the port's own unsharded evaluator, and decrypt to the
integer product. Covered: data parallel; limb-sharded mult+relin of BFV,
CKKS and BGV, with uneven cuts (5 limbs: 3/2 and 2/2/1/0) and ranks with
no limbs (2 limbs over 4 ranks); coefficient-sharded mult+relin of all
three; the limb-sharded rotation and mod switch (CKKS: the rescale), the
mod switch also at the level below the first (the first level's cut, less
the dropped limb); the (2, 2) mesh's mult+relin and its rotation chained into the mod switch; the
sharded app matmul. A collective counter stands in for troy_tpu's HLO
check: the limb and coefficient regimes communicate, DP and the app matmul
do not. Also kernel R1's plain version against Python integers, J's
per-shard tables composed into the whole transform, and the launcher's
failure and timeout paths.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as PS
import pytest
import torch

import troy_tpu as T
from troy_tpu import prng as rnd
from troy_tpu.parallel import sharding as jpar

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch.ops import ntt as dntt
from troy_tpu_torch.ops import ntt_mxu
from troy_tpu_torch.ops import shard as dshard
from troy_tpu_torch.parallel import sharding as par
from troy_tpu_torch.parallel import spmd

torch.set_num_threads(1)

N = 64
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 240.0
CKKS_SCALE = 2.0 ** 25
# name: (scheme, primes' bits incl. the special prime, plain modulus bits)
CONTEXTS = {
    "bfv": ("bfv", [30, 30, 30], 16),          # 2 data limbs
    "bfv5": ("bfv", [30] * 6, 16),             # 5 data limbs: uneven
    "ckks": ("ckks", [40] * 5, 0),             # 4 data limbs
    "bgv": ("bgv", [30] * 4, 16),              # 3 data limbs
}


class Scheme:
    """troy_tpu's objects of one context and the port's spec of it."""

    def __init__(self, name, seed):
        scheme, bits, t_bits = CONTEXTS[name]
        kw = {}
        if scheme != "ckks":
            kw["plain_modulus"] = T.PlainModulus.batching(N, t_bits)
        parms = T.EncryptionParameters(
            scheme=getattr(T.SchemeType, scheme), poly_modulus_degree=N,
            coeff_modulus=tuple(T.CoeffModulus.create(N, bits)), **kw)
        self.name, self.scheme = name, scheme
        self.ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
        kg = T.KeyGenerator(self.ctx, seed=rnd.seed_from_uint64(seed))
        self.rlk = kg.create_relin_keys()
        self.gk = kg.create_galois_keys(steps=[1, 2])
        self.enc = T.Encryptor(self.ctx, secret_key=kg.secret_key,
                               seed=rnd.seed_from_uint64(seed + 1))
        self.dec = T.Decryptor(self.ctx, kg.secret_key)
        self.ev = T.Evaluator(self.ctx)
        self.k = self.ctx.first_context_data.limbs
        if scheme == "ckks":
            self.encoder = T.CKKSEncoder(self.ctx)
            self.t = None
        else:
            self.encoder = T.BatchEncoder(self.ctx)
            self.t = int(self.ctx.first_context_data.plain_modulus)
        self.spec = {"scheme": scheme, "n": N,
                     "q": [int(m) for m in T.CoeffModulus.create(N, bits)],
                     "t": self.t or 0}

    def values(self, i):
        """Seeded slot values: integers mod t, or reals for CKKS."""
        rng = np.random.default_rng(1000 + i)
        if self.t is None:
            return rng.uniform(-1, 1, N // 2)
        return rng.integers(0, self.t, N, dtype=np.uint64)

    def encrypt(self, i, scale=CKKS_SCALE):
        v = self.values(i)
        pt = self.encoder.encode(v, scale) if self.t is None \
            else self.encoder.encode(v)
        return self.enc.encrypt_symmetric(pt)

    def decode(self, words, level, scale):
        ct = T.Ciphertext(data=jnp.asarray(words), level=level,
                          is_ntt_form=self.scheme != "bfv", scale=scale)
        return self.encoder.decode(self.dec.decrypt(ct))


def _mesh(size):
    return jpar.make_mesh(size)


def _largest_divisor(k):
    return max(d for d in range(1, 9) if k % d == 0)


def _words(x):
    return np.asarray(x, dtype=np.uint64)


# --------------------------------------------------------------------------
# troy_tpu's side: the inputs, its runners' words, the expected values
# --------------------------------------------------------------------------

def _jax_cases():
    s = {name: Scheme(name, 11 + 10 * i) for i, name in
         enumerate(CONTEXTS)}
    jobs, expect = [], {}

    def add(job, want, check):
        jobs.append(job)
        expect[job["name"]] = (want, check)

    # data parallel: a batch of 8 pairs on the 8-device mesh
    b = s["bfv"]
    c1 = [b.encrypt(i) for i in range(8)]
    c2 = [b.encrypt(10 + i) for i in range(8)]
    d1 = jnp.stack([c.data for c in c1])
    d2 = jnp.stack([c.data for c in c2])
    m8 = _mesh(8)
    out = jpar.batched_multiply_relin(b.ctx, b.rlk, m8)(
        jpar.shard_batch(m8, d1), jpar.shard_batch(m8, d2))
    add({"name": "dp_bfv", "regime": "dp_multiply_relin", "context": "bfv",
         "key": "bfv_rlk", "inputs": [_words(d1), _words(d2)]},
        _words(out), ("product", "bfv", [(i, 10 + i) for i in range(8)]))

    # limb and coefficient sharded mult+relin, every scheme
    for name in ("bfv", "bfv5", "ckks", "bgv"):
        sc = s[name]
        a, c = sc.encrypt(20), sc.encrypt(21)
        mesh = _mesh(_largest_divisor(sc.k))
        spec = NamedSharding(mesh, PS(None, "dp", None))
        out = jpar.limb_sharded_multiply_relin(sc.ctx, sc.rlk, mesh)(
            jax.device_put(a.data, spec), jax.device_put(c.data, spec))
        inputs = [_words(a.data), _words(c.data)]
        add({"name": f"limb_{name}", "regime": "limb_multiply_relin",
             "context": name, "key": f"{name}_rlk", "inputs": inputs},
            _words(out), ("product", name, [(20, 21)]))
        if name == "bfv5":
            continue
        spec = NamedSharding(m8, PS(None, None, "dp"))
        out = jpar.coeff_sharded_multiply_relin(sc.ctx, sc.rlk, m8)(
            jax.device_put(a.data, spec), jax.device_put(c.data, spec))
        add({"name": f"coeff_{name}", "regime": "coeff_multiply_relin",
             "context": name, "key": f"{name}_rlk", "inputs": inputs},
            _words(out), ("product", name, [(20, 21)]))

    # limb-sharded rotation by one step and mod switch (CKKS: rescale)
    for name in ("bfv5", "ckks", "bgv"):
        sc = s[name]
        a = sc.encrypt(30)
        mesh = _mesh(_largest_divisor(sc.k))
        spec = NamedSharding(mesh, PS(None, "dp", None))
        rot = jpar.limb_sharded_rotate(sc.ctx, sc.gk, 1, mesh)(
            jax.device_put(a.data, spec))
        add({"name": f"rotate_{name}", "regime": "limb_rotate",
             "context": name, "key": f"{name}_gk", "steps": 1,
             "inputs": [_words(a.data)]},
            _words(rot), ("rotate", name, 30))
        # CKKS rescales: encoded at 2^25 q_last, the result at 2^25
        scale = CKKS_SCALE * sc.ctx.first_context_data.coeff_values[-1]
        a = sc.encrypt(31, scale)
        ms = jpar.limb_sharded_mod_switch(sc.ctx, mesh)(
            jax.device_put(a.data, spec))
        add({"name": f"mod_switch_{name}", "regime": "limb_mod_switch",
             "context": name, "inputs": [_words(a.data)]},
            _words(ms), ("mod_switch", name, 31))

    # the mod switch one level down, on the first level's cut less the
    # dropped limb (5 limbs over 2 ranks: 3/1 at 4 limbs, 3/0 after it)
    sc = s["bfv5"]
    a = sc.ev.mod_switch_to_next(sc.encrypt(32))
    level = sc.ctx.first_level + 1
    mesh = _mesh(_largest_divisor(a.data.shape[-2]))
    ms = jpar.limb_sharded_mod_switch(sc.ctx, mesh, level=level)(
        jax.device_put(a.data, NamedSharding(mesh, PS(None, "dp", None))))
    add({"name": "mod_switch_next_bfv5", "regime": "limb_mod_switch",
         "context": "bfv5", "level": level, "inputs": [_words(a.data)]},
        _words(ms), ("mod_switch", "bfv5", 32))

    # the 2-D mesh: troy_tpu on (4, 2), the port on (2, 2)
    mesh2d = jpar.make_mesh_2d(4, 2)
    spec = NamedSharding(mesh2d, PS("dp", None, "tp", None))
    c1 = [b.encrypt(40 + i) for i in range(4)]
    c2 = [b.encrypt(50 + i) for i in range(4)]
    d1 = jnp.stack([c.data for c in c1])
    d2 = jnp.stack([c.data for c in c2])
    out = jpar.dp_limb_sharded_multiply_relin(b.ctx, b.rlk, mesh2d)(
        jax.device_put(d1, spec), jax.device_put(d2, spec))
    add({"name": "dp_limb_bfv", "regime": "dp_limb_multiply_relin",
         "context": "bfv", "key": "bfv_rlk", "mesh": [2, 2],
         "inputs": [_words(d1), _words(d2)]},
        _words(out), ("product", "bfv", [(40 + i, 50 + i) for i in range(4)]))
    rot = jpar.dp_limb_sharded_rotate(b.ctx, b.gk, 2, mesh2d)(
        jax.device_put(d1, spec))
    ms = jpar.dp_limb_sharded_mod_switch(b.ctx, mesh2d)(rot)
    add({"name": "dp_limb_rotate_mod_switch_bfv",
         "regime": "dp_limb_rotate_mod_switch", "context": "bfv",
         "key": "bfv_gk", "mesh": [2, 2], "steps": 2,
         "inputs": [_words(d1)]},
        _words(ms), ("rotate_mod_switch", "bfv", [40 + i for i in range(4)]))

    # the app matmul (as tests/test_sharding.py's)
    from troy_tpu.app.linear import MatmulHelper
    rng = np.random.default_rng(23)
    B, I, O = 12, 4, 3
    x = rng.integers(0, b.t, size=(B, I), dtype=np.uint64)
    w = rng.integers(0, b.t, size=(I, O), dtype=np.uint64)
    helper = MatmulHelper(B, I, O, N, objective=0, pack_lwe=False)
    x_ct = helper.encode_inputs(b.encoder.encode_polynomial, x) \
        .encrypt_symmetric(b.enc)
    w_pt = helper.encode_weights(b.encoder.encode_polynomial, w)
    blocks = len(x_ct.data)
    y_ct = jpar.sharded_app_matmul(
        T.Evaluator(b.ctx),
        _mesh(max(d for d in range(1, 9) if blocks % d == 0)), x_ct, w_pt)
    cts = np.stack([np.stack([_words(c.data) for c in row])
                    for row in x_ct.data])
    pts = np.stack([np.stack([_words(p.data) for p in row])
                    for row in w_pt.data])
    want = np.stack([np.stack([_words(c.data) for c in row])
                     for row in y_ct.data])
    add({"name": "app_bfv", "regime": "app_matmul", "context": "bfv",
         "inputs": [cts, pts], "level": x_ct.data[0][0].level,
         "ntt_form": False},
        want, ("app", "bfv", (helper, x, w, y_ct)))

    keys = {}
    for name, sc in s.items():
        keys[f"{name}_rlk"] = {p: _words(v) for p, v in sc.rlk.keys.items()}
        keys[f"{name}_gk"] = {e: _words(v) for e, v in sc.gk.keys.items()}
    spec = {"contexts": {name: sc.spec for name, sc in s.items()},
            "keys": keys, "jobs": jobs, "reps": 0}
    return s, spec, expect


@pytest.fixture(scope="module")
def cases():
    return _jax_cases()


@pytest.fixture(scope="module")
def ranks(cases):
    """The port's run of every job, in 2 and 4 spawned gloo ranks (the 2-D
    jobs only in 4)."""
    _, spec, _ = cases
    runs = {}
    for world in WORLDS:
        jobs = [j for j in spec["jobs"] if not j.get("mesh")
                or j["mesh"][0] * j["mesh"][1] == world]
        runs[world] = par.spawn(spmd.run_jobs, world, "gloo", "cpu",
                                (dict(spec, jobs=jobs),),
                                timeout_s=SPAWN_TIMEOUT_S)
    return runs


# --------------------------------------------------------------------------
# the port's unsharded evaluator on the same words
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unsharded(cases):
    s, spec, expect = cases
    ctxs = {}
    for name, cs in spec["contexts"].items():
        parms = P.EncryptionParameters(
            scheme=getattr(P.SchemeType, cs["scheme"]),
            poly_modulus_degree=N,
            coeff_modulus=tuple(P.Modulus(q) for q in cs["q"]),
            plain_modulus=P.Modulus(cs["t"]))
        ctxs[name] = P.HeContext(parms, sec_level=P.SecurityLevel.none,
                                 device="cpu")
    out = {}
    for job in spec["jobs"]:
        ctx = ctxs[job["context"]]
        ev = P.Evaluator(ctx)
        ntt = ctx.scheme != P.SchemeType.bfv
        level = job.get("level", ctx.first_level)
        ct = lambda w: interop.ciphertext(w, level, ntt, "cpu")
        regime = job["regime"]
        if regime == "app_matmul":
            from troy_tpu_torch.app.linear import Cipher2d, Plain2d
            from troy_tpu_torch.app.linear import _run_tile_contraction
            cts, pts = job["inputs"]
            y = _run_tile_contraction(
                ev, Cipher2d([[ct(c) for c in row] for row in cts]),
                Plain2d([[interop.plaintext(p, "cpu") for p in row]
                         for row in pts]), False, False, False)
            out[job["name"]] = np.stack([np.stack([interop.to_numpy(c.data)
                                                   for c in row])
                                         for row in y.data])
            continue
        keys = spec["keys"].get(job.get("key"), {})
        if regime in ("dp_multiply_relin", "limb_multiply_relin",
                      "coeff_multiply_relin", "dp_limb_multiply_relin"):
            rlk = interop.relin_keys(keys, "cpu")
            a, b = job["inputs"]
            batch = a if a.ndim == 4 else a[None]
            res = [ev.relinearize(ev.multiply(ct(x), ct(y)), rlk).data
                   for x, y in zip(batch, b if b.ndim == 4 else b[None])]
            res = torch.stack(res) if a.ndim == 4 else res[0]
        elif regime == "limb_rotate":
            gk = interop.galois_keys(keys, "cpu")
            c = ct(job["inputs"][0])
            res = (ev.rotate_vector(c, 1, gk) if ctx.scheme ==
                   P.SchemeType.ckks else ev.rotate_rows(c, 1, gk)).data
        elif regime == "limb_mod_switch":
            c = ct(job["inputs"][0])
            res = (ev.rescale_to_next(c) if ctx.scheme == P.SchemeType.ckks
                   else ev.mod_switch_to_next(c)).data
        else:                           # dp_limb_rotate_mod_switch
            gk = interop.galois_keys(keys, "cpu")
            res = torch.stack([ev.mod_switch_to_next(ev.rotate_rows(
                ct(x), job["steps"], gk)).data for x in job["inputs"][0]])
        out[job["name"]] = interop.to_numpy(res)
    return out


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

JOBS = ["dp_bfv", "limb_bfv", "coeff_bfv", "limb_bfv5", "limb_ckks",
        "coeff_ckks", "limb_bgv", "coeff_bgv", "rotate_bfv5",
        "mod_switch_bfv5", "mod_switch_next_bfv5", "rotate_ckks",
        "mod_switch_ckks", "rotate_bgv", "mod_switch_bgv", "dp_limb_bfv",
        "dp_limb_rotate_mod_switch_bfv", "app_bfv"]
# every job in every rank count, the 2-D ones on their (2, 2) mesh only
RUNS = [pytest.param(name, world, id=f"{name}-{world}")
        for world in WORLDS for name in JOBS
        if world == 4 or not name.startswith("dp_limb")]


@pytest.mark.parametrize("name, world", RUNS)
def test_words_equal_troy_tpu_and_unsharded(cases, ranks, unsharded, world,
                                            name):
    """Gathered output, tolerance 0, against troy_tpu's runner (or its
    evaluator) and the port's unsharded evaluator."""
    got = ranks[world][0]["results"][name]["out"]
    want, _ = cases[2][name]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, unsharded[name])


@pytest.mark.parametrize("name", JOBS)
def test_results_decrypt(cases, ranks, name):
    """The 4-rank output (2-D: the (2, 2) mesh) decrypts to the integer
    product, the rotated or the switched slots (CKKS within 1e-3)."""
    s, _, expect = cases
    got = ranks[4][0]["results"][name]["out"]
    _, (kind, ctx_name, what) = expect[name]
    sc = s[ctx_name]
    lvl = sc.ctx.first_level
    if kind == "app":
        helper, x, w, y_ct = what
        from troy_tpu.app.linear import Cipher2d
        grid = Cipher2d([[y_ct.data[i][j].replace(
            data=jnp.asarray(got[i, j])) for j in range(got.shape[1])]
            for i in range(got.shape[0])])
        y = helper.decrypt_outputs(sc.encoder.decode_polynomial, sc.dec,
                                   grid)
        np.testing.assert_array_equal(
            y.astype(object) % sc.t, (x.astype(object) @ w.astype(object))
            % sc.t)
        return
    if kind == "product":
        batch = got if got.ndim == 4 else got[None]
        for words, (i, j) in zip(batch, what):
            scale = CKKS_SCALE ** 2 if sc.t is None else 1.0
            dec = sc.decode(words, lvl, scale)
            if sc.t is None:
                assert np.abs(dec - sc.values(i) * sc.values(j)).max() < 1e-3
            else:
                np.testing.assert_array_equal(
                    dec, (sc.values(i).astype(object)
                          * sc.values(j).astype(object) % sc.t)
                    .astype(np.uint64))
        return
    if kind == "rotate":
        v = sc.values(what)
        dec = sc.decode(got, lvl, CKKS_SCALE)
        if sc.t is None:
            assert np.abs(dec - np.roll(v, -1)).max() < 1e-3
        else:
            h = N // 2
            np.testing.assert_array_equal(dec, np.concatenate(
                [np.roll(v[:h], -1), np.roll(v[h:], -1)]))
        return
    if kind == "mod_switch":
        v = sc.values(what)
        scale = CKKS_SCALE if sc.t is None else 1.0
        if sc.scheme == "bgv":
            ct = sc.ev.mod_switch_to_next(sc.encrypt(what))
            ct = ct.replace(data=jnp.asarray(got))
            dec = sc.encoder.decode(sc.dec.decrypt(ct))
        else:
            dec = sc.decode(got, lvl + sc.k - got.shape[-2], scale)
        if sc.t is None:
            assert np.abs(dec - v).max() < 1e-3
        else:
            np.testing.assert_array_equal(dec, v)
        return
    # rotate by 2 then mod switch, batch of 4
    h = N // 2
    for words, i in zip(got, what):
        v = sc.values(i)
        np.testing.assert_array_equal(
            sc.decode(words, lvl + 1, 1.0),
            np.concatenate([np.roll(v[:h], -2), np.roll(v[h:], -2)]))


@pytest.mark.parametrize("name, world", RUNS)
def test_collectives(ranks, world, name):
    """The limb and coefficient regimes communicate (all-gathers and R1's
    partials, broadcasts, all-to-alls), data parallelism and the app
    matmul never do."""
    calls = [rank["results"][name]["collectives"]["calls"]
             for rank in ranks[world]]
    if name.startswith(("dp_bfv", "app")):
        assert all(not c for c in calls)
    elif name.startswith("coeff"):
        assert all(c.get("all_to_all", 0) >= 8 for c in calls)
    elif name.startswith("mod_switch"):
        assert all(c == {"broadcast": 1} for c in calls)
    else:
        assert all(c.get("all_gather", 0) >= 1 for c in calls)


@pytest.mark.parametrize("world", WORLDS)
def test_shards_as_gspmd_cuts_them(ranks, world):
    """Every rank holds ceil(k / w) limbs, the last ones fewer or none: 5
    limbs 3/2 and 2/2/1/0, 2 limbs 1/1 and 1/1/0/0; the mod switch keeps
    each rank's limbs but the dropped one, and so does the next level's
    (the first level's cut: 3/1 and 2/2/0/0 at 4 limbs, then 3/0 and
    2/1/0/0); no rank imported JAX."""
    limbs = lambda name: [rank["results"][name]["shard_shape"][-2]
                          for rank in ranks[world]]
    want5 = {2: [3, 2], 4: [2, 2, 1, 0]}[world]
    assert limbs("limb_bfv5") == want5
    assert limbs("limb_bfv") == {2: [1, 1], 4: [1, 1, 0, 0]}[world]
    dropped = list(want5)
    dropped[max(i for i, x in enumerate(want5) if x)] -= 1
    assert limbs("mod_switch_bfv5") == dropped
    assert limbs("mod_switch_next_bfv5") == {2: [3, 0],
                                             4: [2, 1, 0, 0]}[world]
    assert not any(rank["jax_loaded"] for rank in ranks[world])


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
def test_shard_modsum_plain(w):
    """R1's plain version: the sum of w reduced partials mod each limb's
    prime, against Python integers."""
    qs = [int(m) for m in P.CoeffModulus.create(N, [60, 40, 30])]
    t = dntt.RnsNttTables.from_moduli(N, qs, "cpu")
    rng = np.random.default_rng(w)
    parts = np.stack([np.stack([rng.integers(0, q, (2, N), dtype=np.uint64)
                                for q in qs], axis=1) for _ in range(w)])
    got = interop.to_numpy(dshard.shard_modsum(interop.to_torch(parts,
                                                                 "cpu"), t))
    want = parts.astype(object).sum(axis=0)
    for i, q in enumerate(qs):
        want[:, i] %= q
    np.testing.assert_array_equal(got, want.astype(np.uint64))


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("n", [64, 4096])
def test_mxu_shard_stages_compose_to_the_transform(w, n):
    """J's stages on per-shard tables, with the all-to-alls done by hand,
    give the words of the whole transform (A's) both ways."""
    qs = [int(m) for m in P.CoeffModulus.create(n, [60, 40])]
    tabs = dntt.RnsNttTables.from_moduli(n, qs, "cpu")
    x = interop.to_torch(np.stack([np.random.default_rng(n + w).integers(
        0, q, n, dtype=np.uint64) for q in qs]), "cpu")
    shards = [[ntt_mxu.make_shard_tables(n, q, "cpu", w, i) for q in qs]
              for i in range(w)]
    A, B = shards[0][0].a, shards[0][0].b

    def blocks(y, stage, dim, size):
        """Each rank's block of y along dim through its stage."""
        return torch.cat([ntt_mxu.mxu_stage_plain(
            y.narrow(dim, i * size, size), shards[i], stage)
            for i in range(w)], dim=dim)

    k = len(qs)
    fwd = blocks(blocks(x.reshape(k, A, B), "forward_left", -1, B // w),
                 "forward_right", -2, A // w).reshape(k, n)
    assert torch.equal(fwd, dntt.rns_ntt_forward(x, tabs))
    inv = blocks(blocks(fwd.reshape(k, A, B), "inverse_right", -2, A // w),
                 "inverse_left", -1, B // w).reshape(k, n)
    assert torch.equal(inv, x)


@pytest.mark.parametrize("first", [1, 2, 5, 6])
def test_limb_runs_one_cut_for_every_level(first):
    """Every level's limbs are the first level's GSPMD cut less the
    dropped limbs: contiguous, in rank order, covering the level, each
    rank's run only shrinking as limbs drop; shard_limbs cuts so."""
    for w in (1, 2, 3, 4, 8):
        top = par.limb_runs(first, first, w)
        assert top == tuple(interop.shard_range(first, w, i)
                            for i in range(w))
        for k in range(first, 0, -1):
            runs = par.limb_runs(first, k, w)
            assert [i for r in runs for i in r] == list(range(k))
            assert all(set(r) <= set(t) for r, t in zip(runs, top))
    assert [len(r) for r in par.limb_runs(5, 5, 4)] == [2, 2, 1, 0]
    assert [len(r) for r in par.limb_runs(5, 4, 2)] == [3, 1]


def test_shard_limbs_below_the_first_level():
    """shard_limbs of a lower level's data takes the first level's cut,
    given the first level's limb count, and GSPMD's cut of its own k
    without it."""

    class OneAxis:
        def __init__(self, w, i):
            self.w, self.i = w, i

        def size(self, axis):
            return self.w

        def index(self, axis):
            return self.i

    data = torch.arange(4 * 3).reshape(1, 4, 3)
    cut = lambda i, **kw: par.shard_limbs(OneAxis(2, i), data, **kw)
    assert [cut(i, first=5).shape[1] for i in range(2)] == [3, 1]
    assert [cut(i).shape[1] for i in range(2)] == [2, 2]
    assert torch.equal(torch.cat([cut(i, first=5) for i in range(2)], 1),
                       data)


def test_app_rows_of_a_transposed_grid_refused():
    """A rank's rows are rows of the untransposed ciphertext grid."""
    from troy_tpu_torch.app.linear import _run_tile_contraction
    with pytest.raises(ValueError, match="transposed"):
        _run_tile_contraction(None, None, None, True, False, False,
                              rows=range(0, 1))


def test_spawn_reraises_a_rank_failure():
    """A rank's exception comes back with its traceback, the other ranks
    stopped."""
    spec = {"contexts": {}, "jobs": [{"name": "x", "regime": "nonsense",
                                      "context": "bfv"}]}
    spec["contexts"]["bfv"] = {"scheme": "bfv", "n": N, "q": [
        int(m) for m in P.CoeffModulus.create(N, [30, 30])],
        "t": int(P.PlainModulus.batching(N, 16))}
    with pytest.raises(RuntimeError, match="unknown regime"):
        par.spawn(spmd.run_jobs, 2, "gloo", "cpu", (spec,), timeout_s=120)


def test_spawn_times_out():
    """A run that outlasts its timeout fails the call instead of hanging
    the suite."""
    import time
    with pytest.raises(TimeoutError):
        par.spawn(time.sleep, 2, "gloo", "cpu", (120,), timeout_s=3)


def test_explicit_backend():
    """No silent choice: an unknown backend, or NCCL off the card, is
    refused."""
    with pytest.raises(ValueError, match="backend"):
        par.init_mesh_process(0, 1, "mpi", "cpu", "/nonexistent")
    with pytest.raises(ValueError, match="nccl"):
        par.init_mesh_process(0, 1, "nccl", "cpu", "/nonexistent")
