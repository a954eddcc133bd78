"""Kernels D and I as fused for the zero encryptions, against troy_tpu on the
CPU.

Each fused form of kernel D (troy_tpu_torch/ops/poly.py: the symmetric and
public-key zero encryptions' finishes, the switching-key rows, the balanced
add and sub) against the composition of troy_tpu/ops/poly.py's rns_add,
rns_neg and rns_scalar_mul it replaces, on seeded random words and on the
edge words 0 and q - 1; kernel I's one-launch draws (ops/sampling.py
``sample_zero_sym_rns``, ``sample_zero_asym_rns``) against troy_tpu.rlwe's
samplers, for one seed and vmapped over a batch of seeds; the port's
symmetric, batched and public-key encryptions of BFV, CKKS and BGV, its
device switching key (keygen._kswitch_key_core) and BGV's add and sub at
unequal correction factors against troy_tpu's on the same seeds and
words. n = 256, q = {60,40,40,60}, t = PlainModulus.batching(256, 20).
Tolerance 0: every result is words. The last test counts the calls of the
D and I wrappers on the CPU path per op: one launch of each where the
composition took two to eight.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import troy_tpu as J
from troy_tpu import keygen as jkeygen
from troy_tpu import prng as jprng
from troy_tpu import rlwe as jrlwe
from troy_tpu.ops import poly as jpoly
from troy_tpu.ops import rns as jrns
from troy_tpu.ops import u64ops as ju

import troy_tpu_torch as P
from troy_tpu_torch import interop, keygen, rlwe
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.ops import poly, sampling

torch.set_num_threads(2)

N = 256
BITS = [60, 40, 40, 60]
SCALE = 2.0 ** 30
SEED = 1616
SCHEMES = ("bfv", "ckks", "bgv")


def _np(x):
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return interop.to_torch(np.asarray(x, dtype=np.uint64), "cpu")


def _ctx(mod, scheme):
    extra = {} if scheme == "ckks" else {
        "plain_modulus": mod.PlainModulus.batching(N, 20)}
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=N,
        coeff_modulus=tuple(mod.CoeffModulus.create(N, BITS)), **extra)
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)


@pytest.fixture(scope="module")
def ctxs():
    return {s: {m: _ctx(m, s) for m in (J, P)} for s in SCHEMES}


@pytest.fixture(scope="module")
def key_level(ctxs):
    """(troy_tpu's and the port's BGV key-level data)."""
    return ctxs["bgv"][J].key_context_data, ctxs["bgv"][P].key_context_data


def _words(rng, shape, values, edge):
    """Reduced words of (..., k, n); with ``edge``, every word 0 or q - 1."""
    cols = []
    for q in values:
        if edge:
            w = np.where(rng.integers(0, 2, shape[:-2] + (1, shape[-1])),
                         q - 1, 0).astype(np.uint64)
        else:
            w = rng.integers(0, q, shape[:-2] + (1, shape[-1]),
                             dtype=np.uint64)
        cols.append(w)
    return np.concatenate(cols, axis=-2)


# --------------------------------------------------------------------------
# kernel D's fused forms against troy_tpu's compositions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("edge", [False, True], ids=["random", "edge"])
@pytest.mark.parametrize("with_m", [False, True], ids=["zero", "plain"])
def test_zero_sym_finish_is_neg_add_then_add(key_level, edge, with_m):
    jcd, pcd = key_level
    rng = np.random.default_rng(int(edge) * 2 + int(with_m))
    x, y, m = (_words(rng, (3, 4, N), pcd.coeff_values, edge)
               for _ in range(3))
    jt = jcd.ntt
    want = jpoly.rns_neg(jpoly.rns_add(jnp.asarray(x), jnp.asarray(y), jt),
                         jt)
    if with_m:
        want = jpoly.rns_add(want, jnp.asarray(m), jt)
    got = poly.zero_sym_finish(_t(x), _t(y), pcd.ntt,
                               _t(m) if with_m else None)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # into c0 of a ciphertext batch, c1 copied beside it in the same call
    c1 = _words(rng, (3, 4, N), pcd.coeff_values, edge)
    ct = torch.zeros((3, 2, 4, N), dtype=torch.int64)
    poly.zero_sym_finish(_t(x), _t(y), pcd.ntt, _t(m) if with_m else None,
                         out=ct[:, 0], c1=_t(c1))
    np.testing.assert_array_equal(_np(ct[:, 0]), np.asarray(want))
    np.testing.assert_array_equal(_np(ct[:, 1]), c1)


@pytest.mark.parametrize("edge", [False, True], ids=["random", "edge"])
def test_zero_asym_finish_is_add_then_add_on_c0(key_level, edge):
    jcd, pcd = key_level
    rng = np.random.default_rng(10 + int(edge))
    x, y = (_words(rng, (2, 4, N), pcd.coeff_values, edge) for _ in range(2))
    m = _words(rng, (4, N), pcd.coeff_values, edge)
    jt = jcd.ntt
    c = jpoly.rns_add(jnp.asarray(x), jnp.asarray(y), jt)
    want = np.asarray(c).copy()
    want[0] = np.asarray(jpoly.rns_add(c[0], jnp.asarray(m), jt))
    got = poly.zero_asym_finish(_t(x), _t(y), pcd.ntt, _t(m))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(poly.zero_asym_finish(_t(x), _t(y), pcd.ntt)), np.asarray(c))


@pytest.mark.parametrize("edge", [False, True], ids=["random", "edge"])
def test_switching_key_rows_is_keygen_composition(key_level, edge):
    """troy_tpu/keygen.py:47-54 on zero encryptions' parts: -(x + y), P w_j
    added on limb j of row j, c1 = a."""
    jcd, pcd = key_level
    rng = np.random.default_rng(20 + int(edge))
    d = len(pcd.coeff_values) - 1
    x, y, a = (_words(rng, (d, 4, N), pcd.coeff_values, edge)
               for _ in range(3))
    w = _words(rng, (1, 4, N), pcd.coeff_values, edge)[0]     # (k, n)
    jt = jcd.ntt
    c0 = np.array(jpoly.rns_neg(jpoly.rns_add(jnp.asarray(x),
                                               jnp.asarray(y), jt), jt))
    special = pcd.coeff_values[-1]
    for j in range(d):
        qj = pcd.coeff_values[j]
        term = jrns.smul(jnp.asarray(w[j]), special % qj, qj)
        c0[j, j] = np.asarray(ju.add_mod(jnp.asarray(c0[j, j]), term, qj))
    got = poly.switching_key_rows(_t(x), _t(y), _t(a), _t(w), special,
                                  pcd.ntt)
    assert got.shape == (d, 2, 4, N)
    np.testing.assert_array_equal(_np(got[:, 0]), c0)
    np.testing.assert_array_equal(_np(got[:, 1]), a)


@pytest.mark.parametrize("subtract", [False, True], ids=["add", "sub"])
@pytest.mark.parametrize("edge", [False, True], ids=["random", "edge"])
def test_balanced_add_is_two_scalar_products_and_add(key_level, edge,
                                                     subtract):
    jcd, pcd = key_level
    rng = np.random.default_rng(30 + 2 * int(edge) + int(subtract))
    x, y = (_words(rng, (2, 4, N), pcd.coeff_values, edge) for _ in range(2))
    e1, e2 = 3, 786431
    jt = jcd.ntt
    op = jpoly.rns_sub if subtract else jpoly.rns_add
    want = op(jpoly.rns_broadcast_scalar_mul(jnp.asarray(x), e1, jt),
              jpoly.rns_broadcast_scalar_mul(jnp.asarray(y), e2, jt), jt)
    got = poly.balanced_add(_t(x), _t(y), e1, e2, pcd.ntt, subtract)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# --------------------------------------------------------------------------
# kernel I's one-launch draws against troy_tpu's samplers
# --------------------------------------------------------------------------

def _jkey(seed):
    return jrlwe._key_from_seed(jnp.uint64(seed))


def _jcbd(key, cd, scale):
    e = jrlwe._lift_centered_i64(jrlwe.sample_cbd_dev(key, cd.n), cd)
    return e if scale is None else jpoly.rns_broadcast_scalar_mul(
        e, scale, cd.ntt)


@pytest.mark.parametrize("bgv", [False, True], ids=["noise", "noise_t"])
def test_zero_sym_draw_matches_jax(key_level, bgv):
    jcd, pcd = key_level
    scale = int(pcd.plain_modulus) if bgv else None
    a_seed, e_seed = 2 ** 64 - 1, 7
    e = torch.empty((4, N), dtype=torch.int64)
    a = torch.empty_like(e)
    sampling.sample_zero_sym_rns(a_seed, e_seed, pcd.ntt, scale, e, a)
    np.testing.assert_array_equal(
        _np(a), np.asarray(jrlwe.sample_uniform_rns_dev(_jkey(a_seed), jcd)))
    np.testing.assert_array_equal(_np(e),
                                  np.asarray(_jcbd(_jkey(e_seed), jcd, scale)))
    # B seed pairs: troy_tpu's vmapped draws, into slices of one buffer
    a_seeds = np.array([1, 2 ** 63 + 5, 12], dtype=np.uint64)
    e_seeds = np.array([0, 9, 2 ** 64 - 2], dtype=np.uint64)
    buf = torch.empty((2, 3, 4, N), dtype=torch.int64)
    sampling.sample_zero_sym_rns(_t(a_seeds), _t(e_seeds), pcd.ntt, scale,
                                 buf[0], buf[1])
    want_a = jax.vmap(lambda s: jrlwe.sample_uniform_rns_dev(
        jrlwe._key_from_seed(s), jcd))(jnp.asarray(a_seeds))
    want_e = jax.vmap(lambda s: _jcbd(jrlwe._key_from_seed(s), jcd, scale))(
        jnp.asarray(e_seeds))
    np.testing.assert_array_equal(_np(buf[1]), np.asarray(want_a))
    np.testing.assert_array_equal(_np(buf[0]), np.asarray(want_e))


@pytest.mark.parametrize("bgv", [False, True], ids=["noise", "noise_t"])
def test_zero_asym_draw_matches_jax(key_level, bgv):
    jcd, pcd = key_level
    scale = int(pcd.plain_modulus) if bgv else None
    u_seed, e_seeds = 2 ** 63 + 1, [4, 2 ** 64 - 1, 0]
    got = sampling.sample_zero_asym_rns(u_seed, e_seeds, pcd.ntt, scale)
    assert got.shape == (4, 4, N)
    u = jrlwe._lift_centered_i64(jrlwe.sample_ternary_dev(_jkey(u_seed), N),
                                 jcd)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(u))
    for j, s in enumerate(e_seeds):
        np.testing.assert_array_equal(_np(got[1 + j]),
                                      np.asarray(_jcbd(_jkey(s), jcd, scale)))


# --------------------------------------------------------------------------
# the encryptions, the device switching key and BGV's balanced add
# --------------------------------------------------------------------------

def _plains(scheme, jctx):
    rng = np.random.default_rng(SEED)
    if scheme == "ckks":
        enc = J.CKKSEncoder(jctx)
        plains = [enc.encode(rng.uniform(-1, 1, N // 2), SCALE)
                  for _ in range(3)]
    else:
        enc = J.BatchEncoder(jctx)
        t = int(jctx.first_context_data.plain_modulus)
        plains = [enc.encode(rng.integers(0, t, N, dtype=np.uint64))
                  for _ in range(3)]
    return plains, [interop.plaintext(_np(p.data), "cpu", p.level,
                                      p.is_ntt_form, p.scale)
                    for p in plains]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_encryptions_word_equal_to_troy_tpu(ctxs, scheme):
    """encrypt, encrypt_symmetric (with its seed) and
    encrypt_symmetric_many(3) from the same seeds and plaintext words."""
    jplains, pplains = _plains(scheme, ctxs[scheme][J])
    got = {}
    for mod, prng, plains in ((J, jprng, jplains), (P, tprng, pplains)):
        ctx = ctxs[scheme][mod]
        kg = mod.KeyGenerator(ctx, seed=prng.seed_from_uint64(SEED))
        enc = mod.Encryptor(ctx, kg.create_public_key(), kg.secret_key,
                            seed=prng.seed_from_uint64(SEED + 1))
        cts = [enc.encrypt(plains[0]),
               enc.encrypt_symmetric(plains[1], save_seed=True)]
        cts += enc.encrypt_symmetric_many(plains)
        got[mod] = [(_np(c.data), int(c.seed)) for c in cts]
    for (gw, gs), (ww, ws) in zip(got[P], got[J]):
        np.testing.assert_array_equal(gw, ww)
        assert gs == ws


def test_device_switching_key_word_equal_to_troy_tpu(ctxs):
    """keygen._kswitch_key_core of an external secret key's target w, from
    the same device seeds (troy_tpu/keygen.py:34)."""
    jctx, pctx = ctxs["bgv"][J], ctxs["bgv"][P]
    kg = P.KeyGenerator(pctx, seed=tprng.seed_from_uint64(SEED + 2))
    sk = _np(kg.secret_key.data)
    rng = np.random.default_rng(SEED + 3)
    w = _words(rng, (1, 4, N), pctx.key_context_data.coeff_values,
               False)[0]
    a_seeds = np.array([5, 2 ** 64 - 9, 77], dtype=np.uint64)
    e_seeds = np.array([2 ** 63, 3, 1], dtype=np.uint64)
    want = jkeygen._kswitch_key_core(jnp.asarray(a_seeds),
                                     jnp.asarray(e_seeds), jnp.asarray(w),
                                     jnp.asarray(sk), jctx.key_context_data)
    got = keygen._kswitch_key_core(_t(a_seeds), _t(e_seeds), _t(w), _t(sk),
                                   pctx.key_context_data)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("sizes", [(2, 2), (3, 2), (2, 3)],
                         ids=["2+2", "3+2", "2+3"])
@pytest.mark.parametrize("subtract", [False, True], ids=["add", "sub"])
def test_bgv_add_sub_unequal_factors_word_equal(ctxs, sizes, subtract):
    jctx, pctx = ctxs["bgv"][J], ctxs["bgv"][P]
    cd = pctx.first_context_data
    rng = np.random.default_rng(40 + sizes[0] * 3 + sizes[1])
    words = [_words(rng, (s, cd.limbs, N), cd.coeff_values, False)
             for s in sizes]
    cfs = (5, 777)
    out = {}
    for mod, ev in ((J, J.Evaluator(jctx)), (P, P.Evaluator(pctx))):
        conv = jnp.asarray if mod is J else _t
        a, b = (mod.Ciphertext(data=conv(w), level=cd.chain_index,
                               is_ntt_form=True, correction_factor=cf)
                for w, cf in zip(words, cfs))
        r = ev.sub(a, b) if subtract else ev.add(a, b)
        out[mod] = (_np(r.data), r.correction_factor)
    np.testing.assert_array_equal(out[P][0], out[J][0])
    assert out[P][1] == out[J][1] != cfs[0]


# --------------------------------------------------------------------------
# launches per op on the CPU path
# --------------------------------------------------------------------------

D_WRAPPERS = ("_elementwise", "zero_sym_finish", "zero_asym_finish",
              "switching_key_rows", "balanced_add")
# BFV's finishes with the plain embedding (kernel DG) and the embedding
# alone (kernel G)
DG_WRAPPERS = ("zero_sym_embed", "zero_asym_embed")
G_WRAPPERS = ("bfv_plain_embed",)
I_WRAPPERS = ("sample_uniform_rns", "sample_cbd_rns", "sample_ternary_rns",
              "sample_zero_sym_rns", "sample_zero_asym_rns")


@pytest.fixture
def calls(monkeypatch):
    """Counts of the D and I wrappers' calls (one launch each on a card):
    (I, D) of one call of fn; ``calls.seen`` holds DG's and G's too."""
    seen = {"D": 0, "I": 0, "DG": 0, "G": 0}

    def counted(kernel, fn):
        def wrapper(*args, **kwargs):
            seen[kernel] += 1
            return fn(*args, **kwargs)
        return wrapper

    for kernel, names in (("D", D_WRAPPERS), ("DG", DG_WRAPPERS),
                          ("G", G_WRAPPERS)):
        for name in names:
            monkeypatch.setattr(poly, name,
                                counted(kernel, getattr(poly, name)))
    for name in I_WRAPPERS:
        monkeypatch.setattr(sampling, name,
                            counted("I", getattr(sampling, name)))

    def take(fn):
        for kernel in seen:
            seen[kernel] = 0
        fn()
        return seen["I"], seen["D"]
    take.seen = seen
    return take


@pytest.mark.parametrize("scheme", SCHEMES)
def test_launches_per_op(ctxs, calls, scheme):
    """I and D per op: symmetric and public-key encryption and a device
    switching-key row set one each (a BFV encryption's finish is DG's, with
    its plain embedding: one DG and no G); BGV's add at unequal factors one
    D; expand_seed's single draw one I."""
    ctx = ctxs[scheme][P]
    _, plains = _plains(scheme, ctxs[scheme][J])
    kg = P.KeyGenerator(ctx, seed=tprng.seed_from_uint64(SEED))
    enc = P.Encryptor(ctx, kg.create_public_key(), kg.secret_key,
                      seed=tprng.seed_from_uint64(SEED + 1))
    ext = P.KeyGenerator(ctx, kg.secret_key, tprng.seed_from_uint64(SEED + 2))
    bfv = scheme == "bfv"
    for op in (lambda: enc.encrypt_symmetric(plains[0]),
               lambda: enc.encrypt(plains[0]),
               lambda: enc.encrypt_symmetric_many(plains)):
        assert calls(op) == ((1, 0) if bfv else (1, 1))
        assert (calls.seen["DG"], calls.seen["G"]) == ((1, 0) if bfv
                                                       else (0, 0))
    assert calls(lambda: ext.create_keyswitch_key(kg.secret_key)) == (1, 1)
    ss = enc.encrypt_symmetric(plains[0], save_seed=True)
    assert calls(lambda: rlwe.expand_seed(ss, ctx.first_context_data)) == \
        (1, 0)
    if scheme == "bgv":
        ev = P.Evaluator(ctx)
        a = enc.encrypt_symmetric(plains[0])
        b = a.replace(data=a.data, correction_factor=3)
        assert calls(lambda: ev.add(a, b)) == (0, 1)
        assert calls(lambda: ev.sub(a, b)) == (0, 1)


def test_host_sampled_finish_is_one_d(ctxs, calls):
    """The host-sampled zero encryption's neg(add) is the finish: one D
    (and BGV's t-scaling one more)."""
    for scheme, want in (("ckks", 1), ("bgv", 2)):
        ctx = ctxs[scheme][P]
        kg = P.KeyGenerator(ctx, seed=tprng.seed_from_uint64(SEED))
        cd = ctx.first_context_data
        gen = tprng.UniformRandomGenerator(tprng.seed_from_uint64(SEED + 4))
        assert calls(lambda: rlwe.encrypt_zero_symmetric_reference(
            cd, kg.secret_key, gen, True)) == (0, want)
