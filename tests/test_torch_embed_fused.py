"""Kernels DG and G (the BFV plain embedding round(Q m / t), folded into
kernel D's zero-encryption finish and retiled on D's grid) and AO4p (the
CKKS encode's rounding with O4's statistic in kernel A's forward passes)
against troy_tpu on the CPU.

DG's symmetric and public-key finishes (troy_tpu_torch/ops/poly.py
``zero_sym_embed``, ``zero_asym_embed``) and G (``bfv_plain_embed``, into a
new ciphertext with its other components copied: ``bfv_plain_embed_c0``)
against the composition of troy_tpu/ops/poly.py's rns_add, rns_neg and
bfv_multiply_add_plain (troy_tpu/rlwe.py:125-131, :327-330,
troy_tpu/encryptor.py:29) and the port's own D-then-G and G-then-cat, at
t = 786433, a 20-bit t, a 59-bit t and t = 2^41, over 1 and 6 limbs, with
the edge words m = 0, t - 1, (t - 1)/2, (t + 1)/2 and c0 words 0 and
q - 1; BFV's encrypt, encrypt_symmetric and encrypt_symmetric_many(3)
word-equal to troy_tpu's from the same seeds at n = 64 and 1024; the
add_plain and sub_plain of BFV, CKKS and BGV (sizes 2 and 3) word-equal to
troy_tpu's; AO4p's plain version (``rns_ntt_forward_round_stats`` on the
CPU) giving AO2p's words and O4's statistic at scales 2^40, 2^55 and 2^100
(2^e read above 2^53), for the slot and the polynomial encode; and the
routes: a BFV encryption one DG and no G, ``encode_with_stats`` one AO4p
call and no O4. Tolerance 0: every result is words or an exact maximum.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import troy_tpu as J
from troy_tpu import prng as jprng
from troy_tpu.ops import ntt as jntt
from troy_tpu.ops import poly as jpoly

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.ops import embedding, ntt, poly

torch.set_num_threads(2)

N = 64
SEED = 2222
T_BITS = {"t786433": None, "t20": 20, "t59": 59, "t2^41": None}
LIMB_BITS = {1: [60], 6: [60, 40, 40, 40, 40, 60]}


def _np(x):
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return interop.to_torch(np.asarray(x, dtype=np.uint64), "cpu")


def _plain_modulus(name: str) -> int:
    if name == "t786433":
        return 786433
    if name == "t2^41":
        return 1 << 41
    return int(P.PlainModulus.batching(1024, T_BITS[name]))


class Level:
    """One base's tables in both packages and its embedding constants."""

    def __init__(self, t_name: str, k: int):
        self.moduli = [int(q) for q in P.CoeffModulus.create(
            N, LIMB_BITS[k])]
        self.tt = _plain_modulus(t_name)
        Q = 1
        for q in self.moduli:
            Q *= q
        self.args = (self.tt, Q % self.tt,
                     tuple((Q // self.tt) % q for q in self.moduli))
        self.pt = ntt.RnsNttTables.from_moduli(N, self.moduli, "cpu")
        self.jt = jntt.RnsNttTables.from_moduli(N, self.moduli)

    def words(self, rng, lead):
        """c0-like words (lead, k, n), the first coefficients at 0 and
        q - 1."""
        cols = []
        for q in self.moduli:
            w = rng.integers(0, q, lead + (1, N), dtype=np.uint64)
            w[..., 0] = 0
            w[..., 1] = q - 1
            cols.append(w)
        return np.concatenate(cols, axis=-2)

    def plain(self, rng, lead):
        """Words mod t (lead, n), the edge words first."""
        tt = self.tt
        m = rng.integers(0, tt, lead + (N,), dtype=np.uint64)
        m[..., :4] = [0, tt - 1, (tt - 1) // 2, (tt + 1) // 2]
        return m

    def embed(self, m, c0, subtract=False):
        """troy_tpu's bfv_multiply_add_plain."""
        return np.asarray(jpoly.bfv_multiply_add_plain(
            jnp.asarray(m), jnp.asarray(c0), *self.args, self.jt, subtract))


@pytest.fixture(scope="module", params=[(t, k) for t in T_BITS
                                        for k in LIMB_BITS],
                ids=lambda p: f"{p[0]}-k{p[1]}")
def level(request):
    return Level(*request.param)


# --------------------------------------------------------------------------
# G retiled, DG's finishes: words against troy_tpu's compositions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("subtract", [False, True], ids=["add", "sub"])
def test_plain_embed_is_troy_tpu_embedding(level, subtract):
    """G on a batch of 2, and into a new ciphertext of size 3 with c1 and
    c2 copied: the words of troy_tpu's bfv_multiply_add_plain, and of G
    then torch.cat."""
    rng = np.random.default_rng(SEED + int(subtract))
    m, c0 = level.plain(rng, (2,)), level.words(rng, (2,))
    want = level.embed(m, c0, subtract)
    got = poly.bfv_plain_embed(_t(m), _t(c0), *level.args, level.pt,
                               subtract)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(poly.bfv_multiply_add_plain(_t(m), _t(c0), *level.args,
                                        level.pt, subtract)), want)
    data = level.words(rng, (3,))
    cat = torch.cat([poly.bfv_plain_embed(_t(m[0]), _t(data[0]),
                                          *level.args, level.pt,
                                          subtract).unsqueeze(0),
                     _t(data[1:])])
    got = poly.bfv_plain_embed_c0(_t(data), _t(m[0]), *level.args, level.pt,
                                  subtract)
    np.testing.assert_array_equal(_np(got), _np(cat))
    np.testing.assert_array_equal(_np(got[0]), level.embed(m[0], data[0],
                                                           subtract))


def test_zero_sym_embed_is_finish_then_embedding(level):
    """DG's symmetric finish, one encryption and a batch of 3 into c0 with
    c1 copied: troy_tpu's rns_neg(rns_add(x, y)) then
    bfv_multiply_add_plain, and the port's D finish then G."""
    rng = np.random.default_rng(SEED + 10)
    x, y, c1 = (level.words(rng, (3,)) for _ in range(3))
    m = level.plain(rng, (3,))
    jt = level.jt
    zero = np.asarray(jpoly.rns_neg(jpoly.rns_add(jnp.asarray(x),
                                                  jnp.asarray(y), jt), jt))
    want = level.embed(m, zero)
    composed = poly.bfv_plain_embed(
        _t(m), poly.zero_sym_finish(_t(x), _t(y), level.pt), *level.args,
        level.pt)
    np.testing.assert_array_equal(_np(composed), want)
    one = poly.zero_sym_embed(_t(x[0]), _t(y[0]), _t(m[0]), *level.args,
                              level.pt)
    np.testing.assert_array_equal(_np(one), want[0])
    ct = torch.zeros((3, 2, len(level.moduli), N), dtype=torch.int64)
    poly.zero_sym_embed(_t(x), _t(y), _t(m), *level.args, level.pt,
                        out=ct[:, 0], c1=_t(c1))
    np.testing.assert_array_equal(_np(ct[:, 0]), want)
    np.testing.assert_array_equal(_np(ct[:, 1]), c1)
    # in place, as the encryption finishes over its a s
    xs = _t(x)
    poly.zero_sym_embed(xs, _t(y), _t(m), *level.args, level.pt, out=xs)
    np.testing.assert_array_equal(_np(xs), want)


def test_zero_asym_embed_is_finish_then_embedding_on_c0(level):
    """DG's public-key finish: troy_tpu's rns_add per component, then
    bfv_multiply_add_plain on c0 alone."""
    rng = np.random.default_rng(SEED + 20)
    x, y = (level.words(rng, (2,)) for _ in range(2))
    m = level.plain(rng, ())
    c = np.asarray(jpoly.rns_add(jnp.asarray(x), jnp.asarray(y), level.jt))
    want = c.copy()
    want[0] = level.embed(m, c[0])
    got = poly.zero_asym_embed(_t(x), _t(y), _t(m), *level.args, level.pt)
    np.testing.assert_array_equal(_np(got), want)
    composed = poly.zero_asym_finish(_t(x), _t(y), level.pt)
    composed[0] = poly.bfv_plain_embed(_t(m), composed[0], *level.args,
                                       level.pt)
    np.testing.assert_array_equal(_np(composed), want)
    np.testing.assert_array_equal(
        _np(poly.zero_asym_embed_plain(_t(x), _t(y), _t(m), *level.args,
                                       level.pt)), want)


def test_embed_wrappers_refuse_misfits():
    lv = Level("t786433", 1)
    x = torch.zeros((2, 1, N), dtype=torch.int64)
    with pytest.raises(ValueError):
        poly.zero_sym_embed(x, x, torch.zeros(N, dtype=torch.int64),
                            *lv.args, lv.pt)
    with pytest.raises(ValueError):
        poly.zero_asym_embed(x, x, torch.zeros((2, N), dtype=torch.int64),
                             *lv.args, lv.pt)
    with pytest.raises(ValueError):
        poly.bfv_plain_embed(torch.zeros((2, N), dtype=torch.int64), x,
                             *lv.args, lv.pt, c1=x)
    with pytest.raises(ValueError):
        poly.bfv_plain_embed(torch.zeros((2, N), dtype=torch.int64), x,
                             *lv.args, lv.pt, out=torch.empty((3, 1, N),
                                                              dtype=torch.int64))


M64 = (1 << 64) - 1


def _kernel_embed(m: int, i: int, consts: list) -> int:
    """csrc/plain_embed.cuh's embed_fix and embed_limb on Python ints
    (64-bit products wrap), from G's and DG's constants (EmbedLayout)."""
    tt, half, w, w_shoup = consts[:4]
    k = (len(consts) - 4) // 4
    q, cr_hi, d, d_shoup = (consts[4 + j * k + i] for j in range(4))
    quo = (m * w_shoup) >> 64
    r = (m * w - quo * tt) & M64
    if r >= tt:
        r, quo = r - tt, quo + 1
    fix = quo + (1 if r + half >= tt else 0)
    lazy = (m * d - ((m * d_shoup) >> 64) * q) & M64
    s = lazy + fix
    assert s < (1 << 64)
    if tt <= q:
        s = s - 2 * q if s >= 2 * q else s
        return s - q if s >= q else s
    s = (s - ((s * cr_hi) >> 64) * q) & M64
    return s - q if s >= q else s


def test_kernel_arithmetic_is_the_plain_embedding(level):
    """The kernels' division by t through Q mod t's Shoup word (not the
    plain version's Barrett-128) gives the plain version's words at every
    t and limb count, on the edge words and random ones."""
    rng = np.random.default_rng(SEED + 40)
    consts = [int(v) for v in _np(poly._plain_embed_consts(*level.args,
                                                           level.pt))]
    assert len(consts) == 4 + 4 * len(level.moduli)
    m = level.plain(rng, ())
    zero = np.zeros((len(level.moduli), N), dtype=np.uint64)
    want = level.embed(m, zero)
    got = np.array([[_kernel_embed(int(v), i, consts) for v in m]
                    for i in range(len(level.moduli))], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# BFV's encryptions and the plaintext adds against troy_tpu
# --------------------------------------------------------------------------

def _ctx(mod, scheme, n):
    extra = {} if scheme == "ckks" else {
        "plain_modulus": mod.PlainModulus.batching(n, 20)}
    parms = mod.EncryptionParameters(
        scheme=getattr(mod.SchemeType, scheme), poly_modulus_degree=n,
        coeff_modulus=tuple(mod.CoeffModulus.create(n, [60, 40, 40, 60])),
        **extra)
    on_cpu = {"device": "cpu"} if mod is P else {}
    return mod.HeContext(parms, sec_level=mod.SecurityLevel.none, **on_cpu)


def _plains(scheme, jctx, count, seed):
    rng = np.random.default_rng(seed)
    n = jctx.first_context_data.n
    if scheme == "ckks":
        enc = J.CKKSEncoder(jctx)
        plains = [enc.encode(rng.uniform(-1, 1, n // 2), 2.0 ** 30)
                  for _ in range(count)]
    else:
        enc = J.BatchEncoder(jctx)
        t = int(jctx.first_context_data.plain_modulus)
        plains = [enc.encode(rng.integers(0, t, n, dtype=np.uint64))
                  for _ in range(count)]
        for p in plains[:1]:
            # the edge words of the embedding in the first plaintext
            words = np.array(p.data)
            words[:4] = [0, t - 1, (t - 1) // 2, (t + 1) // 2]
            plains[0] = p.replace(data=jnp.asarray(words))
    return plains, [interop.plaintext(_np(p.data), "cpu", p.level,
                                      p.is_ntt_form, p.scale)
                    for p in plains]


@pytest.mark.parametrize("n", [64, 1024])
def test_bfv_encryptions_word_equal_to_troy_tpu(n):
    """encrypt, encrypt_symmetric (with its seed) and
    encrypt_symmetric_many(3), each one DG finish, from the same seeds and
    plaintext words."""
    ctxs = {mod: _ctx(mod, "bfv", n) for mod in (J, P)}
    jplains, pplains = _plains("bfv", ctxs[J], 3, SEED + n)
    got = {}
    for mod, prng, plains in ((J, jprng, jplains), (P, tprng, pplains)):
        kg = mod.KeyGenerator(ctxs[mod], seed=prng.seed_from_uint64(SEED))
        enc = mod.Encryptor(ctxs[mod], kg.create_public_key(),
                            kg.secret_key,
                            seed=prng.seed_from_uint64(SEED + 1))
        cts = [enc.encrypt(plains[0]),
               enc.encrypt_symmetric(plains[1], save_seed=True)]
        cts += enc.encrypt_symmetric_many(plains)
        got[mod] = [(_np(c.data), int(c.seed)) for c in cts]
    for (gw, gs), (ww, ws) in zip(got[P], got[J]):
        np.testing.assert_array_equal(gw, ww)
        assert gs == ws


@pytest.fixture(scope="module")
def small_ctxs():
    return {s: {m: _ctx(m, s, N) for m in (J, P)}
            for s in ("bfv", "ckks", "bgv")}


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("subtract", [False, True], ids=["add", "sub"])
@pytest.mark.parametrize("scheme", ["bfv", "ckks", "bgv"])
def test_add_plain_word_equal_to_troy_tpu(small_ctxs, scheme, subtract,
                                          size):
    """add_plain and sub_plain (one G or D launch writing c0 and copying
    the other components) on a ciphertext of 2 or 3 components."""
    jctx, pctx = small_ctxs[scheme][J], small_ctxs[scheme][P]
    jplains, pplains = _plains(scheme, jctx, 1, SEED + size)
    cd = pctx.get_context_data(jplains[0].level) if scheme == "ckks" \
        else pctx.first_context_data
    rng = np.random.default_rng(SEED + 30 + size)
    words = np.concatenate([rng.integers(0, q, (size, 1, N), dtype=np.uint64)
                            for q in cd.coeff_values], axis=1)
    ntt_form = scheme != "bfv"
    scale = jplains[0].scale if scheme == "ckks" else 1.0
    out = {}
    for mod, plain in ((J, jplains[0]), (P, pplains[0])):
        conv = jnp.asarray if mod is J else _t
        ct = mod.Ciphertext(data=conv(words), level=cd.chain_index,
                            is_ntt_form=ntt_form, scale=scale,
                            **({"correction_factor": 5}
                               if scheme == "bgv" else {}))
        ev = mod.Evaluator(small_ctxs[scheme][mod])
        r = ev.sub_plain(ct, plain) if subtract else ev.add_plain(ct, plain)
        out[mod] = _np(r.data)
    np.testing.assert_array_equal(out[P], out[J])
    np.testing.assert_array_equal(out[P][1:], words[1:])


# --------------------------------------------------------------------------
# AO4p: AO2p's words and O4's statistic
# --------------------------------------------------------------------------

@pytest.mark.parametrize("log_scale", [40, 55, 100])
def test_round_stats_plain_is_ao2p_words_and_o4_statistic(log_scale):
    n = 1024
    moduli = [int(q) for q in P.CoeffModulus.create(
        n, [60, 60, 60, 60] if log_scale == 100 else [60, 40, 40, 60])]
    tables = ntt.RnsNttTables.from_moduli(n, moduli, "cpu")
    rt = embedding.make_rns_round_tables(tables)
    emb = embedding.make_embed_tables(n, "cpu")
    rng = np.random.default_rng(log_scale)
    # slots up to 16: at 2^55 the largest coefficient passes 2^53
    vals = torch.from_numpy(rng.uniform(-16, 16, n // 2)
                            + 1j * rng.uniform(-16, 16, n // 2))
    u = embedding.embed_inverse_fft(vals, emb)
    scale = 2.0 ** log_scale
    words, stat = embedding.rns_ntt_forward_round_stats(u, emb.untwist,
                                                        scale, rt, tables)
    np.testing.assert_array_equal(
        _np(words), _np(embedding.rns_ntt_forward_round(
            u, emb.untwist, scale, rt, tables)))
    o4_words, o4_stat = embedding.untwist_round_to_rns_stats(u, scale, emb,
                                                             rt)
    np.testing.assert_array_equal(
        _np(words), _np(ntt.rns_ntt_forward(o4_words, tables)))
    assert stat.dtype == torch.float64 and stat.shape == ()
    assert stat.view(torch.int64) == o4_stat.view(torch.int64)
    re = (u * emb.untwist).real.numpy()
    assert float(stat) == float(np.max(np.abs(np.rint(re * scale))))
    if log_scale > 40:
        assert float(stat) >= 2.0 ** 53           # 2^e read
    # the polynomial encode's real words
    c = torch.from_numpy(rng.uniform(-1, 1, n))
    words, stat = embedding.rns_ntt_forward_round_stats(c, None, scale, rt,
                                                        tables)
    np.testing.assert_array_equal(
        _np(words), _np(embedding.rns_ntt_forward_round(c, None, scale, rt,
                                                        tables)))
    assert float(stat) == float(np.max(np.abs(np.rint(c.numpy() * scale))))


def test_round_stats_refuses_j_tables():
    n = 2048
    moduli = [int(q) for q in P.CoeffModulus.create(n, [40, 40])]
    on_j = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=True)
    rt = embedding.make_rns_round_tables(on_j)
    with pytest.raises(ValueError):
        embedding.rns_ntt_forward_round_stats(
            torch.zeros(n, dtype=torch.complex128),
            torch.ones(n, dtype=torch.complex128), 1.0, rt, on_j)


@pytest.mark.parametrize("log_n", range(10, 25))
def test_block_maxima_fit_their_room(log_n):
    """AO4p's first pass writes one maximum a block of row 0 (A's plan,
    csrc/ntt.cu plan: 2^(b - cols) blocks a row, a = log_n / 2, b = log_n -
    a, cols = clamp(10 - a, 0, b)); the wrapper's room, n / 2^10 words,
    holds them at every n the kernel takes."""
    a = log_n // 2
    b = log_n - a
    cols = min(max(10 - a, 0), b)
    assert 2 ** (b - cols) <= max(1, (1 << log_n) >> 10)


# --------------------------------------------------------------------------
# the routes on the CPU path
# --------------------------------------------------------------------------

def _count(monkeypatch, module, names):
    seen = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            seen[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    return seen


def test_bfv_encrypt_runs_dg_and_no_g(small_ctxs, monkeypatch):
    ctx = small_ctxs["bfv"][P]
    _, plains = _plains("bfv", small_ctxs["bfv"][J], 3, SEED)
    kg = P.KeyGenerator(ctx, seed=tprng.seed_from_uint64(SEED))
    enc = P.Encryptor(ctx, kg.create_public_key(), kg.secret_key,
                      seed=tprng.seed_from_uint64(SEED + 1))
    seen = _count(monkeypatch, poly, ("zero_sym_embed", "zero_asym_embed",
                                      "bfv_plain_embed", "zero_sym_finish",
                                      "zero_asym_finish"))
    enc.encrypt_symmetric(plains[0])
    enc.encrypt(plains[0])
    enc.encrypt_symmetric_many(plains)
    assert seen == {"zero_sym_embed": 2, "zero_asym_embed": 1,
                    "bfv_plain_embed": 0, "zero_sym_finish": 0,
                    "zero_asym_finish": 0}


def test_encode_with_stats_runs_ao4p(small_ctxs, monkeypatch):
    ctx = small_ctxs["ckks"][P]
    ce = P.CKKSEncoder(ctx)
    seen = _count(monkeypatch, embedding, (
        "rns_ntt_forward_round_stats", "untwist_round_to_rns_stats",
        "rns_ntt_forward_round"))
    vals = np.linspace(-1, 1, N // 2)
    plain, stats = ce.encode_with_stats(vals, 2.0 ** 30)
    assert seen == {"rns_ntt_forward_round_stats": 1,
                    "untwist_round_to_rns_stats": 0,
                    "rns_ntt_forward_round": 0}
    np.testing.assert_array_equal(_np(plain.data),
                                  _np(ce.encode(vals, 2.0 ** 30).data))
    u = embedding.embed_inverse_fft(torch.from_numpy(vals.astype(complex)),
                                    ce._emb)
    assert float(stats.max_abs_small) == float(
        embedding.round_stats_plain(u, ce._emb.untwist, 2.0 ** 30))
