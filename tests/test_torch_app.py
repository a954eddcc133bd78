"""The app layer of troy_tpu_torch (troy_tpu_torch/app/linear.py) against
troy_tpu's on the CPU.

Every flow of the JAX package's app tests (tests/test_app.py,
tests/test_app_bgv.py, tests/test_app_ckks.py) runs through both packages
from the same seeds and numpy inputs: BFV and BGV at n = 64, q =
{40,40,40}, t = PlainModulus.batching(64, 20); CKKS at n = 256, q =
{40,40,40}, scale 2^30. Keys come from the seeded host-sampling keygen
(word-equal in both packages), encryptions from seeded encryptors on the
default device-sampling path (word-equal too). After each step the port's
words must equal troy_tpu's (tolerance 0): the product grid of matmul,
matmul_cipher (size 3, and relinearized), matmul_reverse, conv2d,
conv2d_cipher and conv2d_reverse; pack_outputs (BFV, and CKKS where a
pack is possible in the NTT domain: one input per block); the bytes of
serialize_outputs and the words after deserialize_outputs; encode_outputs
and Cipher2d.save. The decrypted results must equal troy_tpu's and the
integer oracle mod t exactly (CKKS: within 1e-3 of the float oracle, and
within 1e-9 of troy_tpu's decode).

BGV pack_outputs is held by decryption only: troy_tpu's coefficient-domain
BGV trace is wrong (ROADMAP queue 3), the port's divides in the right
domain. Both tiling searches are held to the rows of tests/test_app.py and
to troy_tpu's choices.
"""

import numpy as np
import pytest
import torch

import troy_tpu as J
from troy_tpu import prng as jprng
from troy_tpu.app import linear as jlin

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch import prng as tprng
from troy_tpu_torch.app import linear as tlin

torch.set_num_threads(2)

SEED = 7070
CKKS_SCALE = 2.0 ** 30
CKKS_TOL = 1e-3


class Side:
    """One package's state for one scheme."""

    def __init__(self, mod, scheme):
        self.mod, self.scheme = mod, scheme
        self.port = mod is P
        self.ckks = scheme == "ckks"
        self.n = 256 if self.ckks else 64
        prng = tprng if self.port else jprng
        self.prng = prng
        extra = {} if self.ckks else {
            "plain_modulus": mod.PlainModulus.batching(self.n, 20)}
        parms = mod.EncryptionParameters(
            scheme=getattr(mod.SchemeType, scheme),
            poly_modulus_degree=self.n,
            coeff_modulus=tuple(mod.CoeffModulus.create(self.n,
                                                         [40, 40, 40])),
            **extra)
        on_cpu = {"device": "cpu"} if self.port else {}
        self.ctx = mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                 **on_cpu)
        kg = mod.KeyGenerator(self.ctx, seed=prng.seed_from_uint64(SEED),
                              host_sampling=True)
        self.sk = kg.secret_key
        self.pk = kg.create_public_key()
        self.ak = kg.create_automorphism_keys()
        self.rlk = kg.create_relin_keys()
        self.dec = mod.Decryptor(self.ctx, self.sk)
        self.ev = mod.Evaluator(self.ctx)
        self.lin = tlin if self.port else jlin
        if self.ckks:
            ce = mod.CKKSEncoder(self.ctx)
            self.ep = lambda v: ce.encode_polynomial(v, CKKS_SCALE)
            self.dp = ce.decode_polynomial
            self.t = None
        else:
            be = mod.BatchEncoder(self.ctx)
            self.ep, self.dp = be.encode_polynomial, be.decode_polynomial
            self.t = int(self.ctx.first_context_data.plain_modulus)

    def encryptor(self, case_seed: int):
        return self.mod.Encryptor(self.ctx, public_key=self.pk,
                                  secret_key=self.sk,
                                  seed=self.prng.seed_from_uint64(case_seed))

    def words(self, x) -> np.ndarray:
        return interop.to_numpy(x) if self.port else np.asarray(x)

    def grid_words(self, grid) -> list:
        return [[self.words(c.data) for c in row] for row in grid.data]

    def values(self, rng, shape, high=None):
        if self.ckks:
            return rng.uniform(-1, 1, shape)
        return rng.integers(0, self.t if high is None else high, shape,
                            dtype=np.uint64)


def _matmul_oracle(x, w, t):
    if t is None:
        return x @ w
    return (x.astype(object) @ w.astype(object)) % t


def _conv_oracle(x, w, t):
    B, CI, H, W = x.shape
    CO, _, KH, KW = w.shape
    oh, ow = H - KH + 1, W - KW + 1
    out = np.zeros((B, CO, oh, ow), dtype=object if t else np.float64)
    xo = x.astype(object) if t else x
    wo = w.astype(object) if t else w
    for b in range(B):
        for co in range(CO):
            for i in range(oh):
                for j in range(ow):
                    out[b, co, i, j] = (xo[b, :, i:i + KH, j:j + KW]
                                        * wo[co]).sum()
    return out % t if t else out


# name -> (schemes, flow kind, arguments): the JAX app tests' flows
FLOWS = {
    "matmul": (("bfv", "bgv", "ckks"), "matmul",
               dict(dims=(4, 5, 6), pack=False, serialize=True)),
    "matmul_pack": (("bfv",), "matmul", dict(dims=(2, 4, 5), pack=True,
                                             serialize=True)),
    # several inner tiles (I = 4; CKKS 2) and output blocks
    "matmul_wide": (("bfv", "bgv", "ckks"), "matmul",
                    dict(dims=(3, 20, 7), pack=False, serialize=True)),
    # I = 4, 8 outputs packed two by two
    "matmul_wide_pack": (("bfv",), "matmul", dict(dims=(6, 8, 40), pack=True,
                                                  serialize=True)),
    "matmul_cipher_wide": (("bfv", "bgv", "ckks"), "matmul",
                           dict(dims=(3, 20, 7), pack=False, cipher=True)),
    "matmul_pack_one_input": (("bfv", "ckks"), "matmul",
                              dict(dims=(2, 1, 5), pack=True,
                                   serialize=True)),
    "matmul_cipher": (("bfv", "bgv", "ckks"), "matmul",
                      dict(dims=(2, 3, 4), pack=False, cipher=True)),
    "matmul_cipher_relin_pack": (("bfv",), "matmul",
                                 dict(dims=(2, 4, 5), pack=True, cipher=True,
                                      relin=True, serialize=True)),
    "matmul_reverse": (("bfv", "ckks"), "matmul",
                       dict(dims=(3, 5, 4), pack=False, reverse=True,
                            objective=1)),
    "conv2d": (("bfv", "bgv", "ckks"), "conv",
               dict(dims=(1, 5, 5, 3, 3, 2, 2), serialize=True)),
    "conv2d_cipher": (("bfv", "ckks"), "conv",
                      dict(dims=(1, 4, 4, 2, 2, 2, 2), cipher=True,
                           high=16)),
    "conv2d_reverse": (("bfv", "ckks"), "conv",
                       dict(dims=(2, 4, 4, 2, 2, 2, 3), reverse=True,
                            objective=1, serialize=True)),
}
CASES = [(scheme, name) for name, (schemes, _, _) in FLOWS.items()
         for scheme in schemes]


# a Plain2d kept in prepared form is held over this many contractions
REUSE_CALLS = 3


def _ct_pt(s, out, plain, op, reuse):
    """The ct x pt product op(plain()). With ``reuse`` (the port), op runs
    REUSE_CALLS times on one Plain2d, then once on each of REUSE_CALLS
    fresh ones: each call's words in out["reused"] and out["fresh"], the
    prepared-grid counts of the two runs in out["counts"]."""
    if not reuse:
        return op(plain())
    pt = plain()
    tlin.reset_prepared_counts()
    ys = [op(pt) for _ in range(REUSE_CALLS)]
    out["reused"] = [s.grid_words(y) for y in ys]
    out["counts"] = [tlin.prepared_counts()]
    tlin.reset_prepared_counts()
    out["fresh"] = [s.grid_words(op(plain())) for _ in range(REUSE_CALLS)]
    out["counts"].append(tlin.prepared_counts())
    return ys[0]


def _matmul(s, enc, rng, dims, pack, cipher=False, relin=False,
            reverse=False, objective=0, serialize=False, reuse=False):
    B, I, O = dims
    x, w = s.values(rng, (B, I)), s.values(rng, (I, O))
    h = s.lin.MatmulHelper(B, I, O, s.n, objective=objective, pack_lwe=pack)
    out = {"blocks": (h.batch_block, h.input_block, h.output_block)}
    if reverse:
        w_ct = h.encode_weights(s.ep, w).encrypt_symmetric(enc)
        y = _ct_pt(s, out, lambda: h.encode_inputs(s.ep, x),
                   lambda pt: h.matmul_reverse(s.ev, pt, w_ct), reuse)
    elif cipher:
        w_ct = h.encode_weights(s.ep, w).encrypt(enc)
        y = h.matmul_cipher(s.ev, h.encrypt_inputs(enc, s.ep, x), w_ct)
        if relin:
            out["product_size3"] = s.grid_words(y)
            y = y.relinearize(s.ev, s.rlk)
    else:
        x_ct = h.encrypt_inputs(enc, s.ep, x)
        y = _ct_pt(s, out, lambda: h.encode_weights(s.ep, w),
                   lambda pt: h.matmul(s.ev, x_ct, pt), reuse)
    out["product"] = s.grid_words(y)
    if pack:
        y = h.pack_outputs(s.ev, s.ak, y)
        out["packed"] = s.grid_words(y)
    if serialize:
        out["blob"] = h.serialize_outputs(s.ev, s.ctx, y)
        y = h.deserialize_outputs(s.ev, s.ctx, out["blob"])
        out["loaded"] = s.grid_words(y)
    out["decrypted"] = h.decrypt_outputs(s.dp, s.dec, y)
    out["expect"] = _matmul_oracle(x, w, s.t)
    out["encoded_outputs"] = [[s.words(p.data) for p in row] for row in
                              h.encode_outputs(s.ep, out["expect"]
                                               if s.t is None else
                                               out["expect"].astype(
                                                   np.uint64)).data]
    return out


def _conv(s, enc, rng, dims, cipher=False, reverse=False, objective=0,
          serialize=False, high=None, reuse=False):
    B, H, W, KH, KW, CI, CO = dims
    x = s.values(rng, (B, CI, H, W), high)
    w = s.values(rng, (CO, CI, KH, KW), high)
    h = s.lin.Conv2dHelper(B, H, W, KH, KW, CI, CO, s.n, objective=objective)
    out = {"blocks": (h.block_batch, h.block_height, h.block_width,
                      h.block_in_channels, h.block_out_channels)}
    if reverse:
        w_ct = h.encode_weights(s.ep, w).encrypt_symmetric(enc)
        y = _ct_pt(s, out, lambda: h.encode_inputs(s.ep, x),
                   lambda pt: h.conv2d_reverse(s.ev, pt, w_ct), reuse)
    elif cipher:
        w_ct = h.encode_weights(s.ep, w).encrypt_symmetric(enc)
        x_ct = h.encode_inputs(s.ep, x).encrypt_symmetric(enc)
        y = h.conv2d_cipher(s.ev, x_ct, w_ct)
    else:
        x_ct = h.encrypt_inputs(enc, s.ep, x)
        y = _ct_pt(s, out, lambda: h.encode_weights(s.ep, w),
                   lambda pt: h.conv2d(s.ev, x_ct, pt), reuse)
    out["product"] = s.grid_words(y)
    out["saved"] = y.save(s.ctx)
    if serialize:
        out["blob"] = h.serialize_outputs(s.ev, s.ctx, y)
        y = h.deserialize_outputs(s.ev, s.ctx, out["blob"])
        out["loaded"] = s.grid_words(y)
    out["decrypted"] = h.decrypt_outputs(s.dp, s.dec, y)
    out["expect"] = _conv_oracle(x, w, s.t)
    expect = out["expect"] if s.t is None else out["expect"].astype(np.uint64)
    out["encoded_outputs"] = [[s.words(p.data) for p in row]
                              for row in h.encode_outputs(s.ep, expect).data]
    return out


_SIDES = {}
_RUNS = {}


def _side(mod, scheme):
    key = (mod.__name__, scheme)
    if key not in _SIDES:
        _SIDES[key] = Side(mod, scheme)
    return _SIDES[key]


def _run(mod, scheme, name, reuse=False):
    key = (mod.__name__, scheme, name, reuse)
    if key not in _RUNS:
        s = _side(mod, scheme)
        _, kind, kw = FLOWS[name]
        index = list(FLOWS).index(name)
        enc = s.encryptor(SEED + 100 + index)
        rng = np.random.default_rng(SEED + index)
        _RUNS[key] = (_matmul if kind == "matmul" else _conv)(
            s, enc, rng, reuse=reuse, **kw)
    return _RUNS[key]


def _same_grids(got, want, what):
    assert len(got) == len(want), what
    for r, (gr, wr) in enumerate(zip(got, want)):
        assert len(gr) == len(wr), what
        for c, (g, w) in enumerate(zip(gr, wr)):
            assert g.shape == w.shape, (what, r, c)
            bad = int((g != w).sum())
            assert bad == 0, f"{what}[{r}][{c}]: {bad} words differ"


@pytest.mark.parametrize("scheme,name", CASES)
def test_flow_words_equal_troy_tpu(scheme, name):
    """Each step's words (and bytes) equal troy_tpu's; the decrypted
    result equals troy_tpu's and the oracle."""
    port, ref = _run(P, scheme, name), _run(J, scheme, name)
    assert port["blocks"] == ref["blocks"]
    for stage in ("product_size3", "product", "packed", "loaded",
                  "encoded_outputs"):
        if stage in ref:
            _same_grids(port[stage], ref[stage], stage)
    for stage in ("blob", "saved"):
        if stage in ref:
            assert port[stage] == ref[stage], f"{stage} bytes differ"
    got, expect = port["decrypted"], port["expect"]
    if scheme == "ckks":
        np.testing.assert_allclose(got.astype(np.float64),
                                   ref["decrypted"].astype(np.float64),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(got.astype(np.float64), expect, rtol=0,
                                   atol=CKKS_TOL)
    else:
        t = _side(P, scheme).t
        np.testing.assert_array_equal(got.astype(object) % t,
                                      ref["decrypted"].astype(object) % t)
        np.testing.assert_array_equal(got.astype(object) % t, expect)


# the ct x pt flows, in every scheme (BGV's reverse flows too)
REUSE_CASES = [(scheme, name) for name in ("matmul", "matmul_reverse",
                                           "conv2d", "conv2d_reverse")
               for scheme in ("bfv", "bgv", "ckks")]


@pytest.mark.parametrize("scheme,name", REUSE_CASES)
def test_reused_plain2d_words_equal_fresh_and_troy_tpu(scheme, name):
    """One Plain2d contracted REUSE_CALLS times builds its prepared grid
    once and then hits; each call's words equal troy_tpu's and those of a
    fresh Plain2d each time, which builds every time."""
    port, ref = _run(P, scheme, name, reuse=True), _run(J, scheme, name)
    for i, words in enumerate(port["reused"] + port["fresh"]):
        _same_grids(words, ref["product"], f"call {i}")
    assert port["counts"] == [{"builds": 1, "hits": REUSE_CALLS - 1},
                              {"builds": REUSE_CALLS, "hits": 0}]


def _grids(s, seed: int, X: int, I: int, Y: int):
    """A ciphertext grid (X, I) and a plaintext grid (I, Y) of random
    tiles, encoded and encrypted as the helpers do."""
    rng = np.random.default_rng(seed)
    poly = lambda: s.ep(s.values(rng, (s.n,)))
    ct2d = tlin.Plain2d([[poly() for _ in range(I)] for _ in range(X)]
                        ).encrypt_symmetric(s.encryptor(seed))
    return ct2d, tlin.Plain2d([[poly() for _ in range(Y)] for _ in range(I)])


def _contract(s, ct2d, pt2d, transpose_pt=False):
    return s.grid_words(tlin._run_tile_contraction(
        s.ev, ct2d, pt2d, False, transpose_pt, False))


def _fresh(pt2d):
    """The same tiles in a Plain2d that keeps nothing yet."""
    return tlin.Plain2d([list(row) for row in pt2d.data])


def _differ(a, b) -> bool:
    return any((x != y).any() for ra, rb in zip(a, b)
               for x, y in zip(ra, rb))


@pytest.mark.parametrize("change", ["tile", "layout", "level"])
@pytest.mark.parametrize("scheme", ["bfv", "bgv", "ckks"])
def test_prepared_grid_rebuilt_when_its_use_changes(scheme, change):
    """A Plain2d's kept grid serves only the tiles, layout and level it
    was built for: a new Plaintext in one tile, the other layout or
    another level rebuilds it (one entry, so going back rebuilds again),
    each answer equal to a fresh Plain2d's; a CKKS Plain2d (NTT form)
    at another level than the ciphertexts' still raises."""
    s = _side(P, scheme)
    ct2d, pt2d = _grids(s, SEED - 8, 2, 3, 3)
    tlin.reset_prepared_counts()
    first = _contract(s, ct2d, pt2d)
    _same_grids(first, _contract(s, ct2d, _fresh(pt2d)), "first")
    if change == "tile":
        pt2d.data[1][2] = s.ep(s.values(np.random.default_rng(SEED - 9),
                                        (s.n,)))
        got = _contract(s, ct2d, pt2d)
        _same_grids(got, _contract(s, ct2d, _fresh(pt2d)), "new tile")
        assert _differ(got, first)
        builds = 4
    elif change == "layout":
        got = _contract(s, ct2d, pt2d, transpose_pt=True)
        _same_grids(got, _contract(s, ct2d, _fresh(pt2d), True),
                    "transposed")
        assert _differ(got, first)
        _same_grids(_contract(s, ct2d, pt2d), first, "back")
        got, builds = first, 5
    elif scheme == "ckks":
        low = ct2d.mod_switch_to_next(s.ev)
        for grid in (pt2d, _fresh(pt2d)):
            with pytest.raises(ValueError,
                               match="NTT-form plaintext level mismatch"):
                _contract(s, low, grid)
        got, builds = first, 2
    else:
        low = ct2d.mod_switch_to_next(s.ev)
        got = _contract(s, low, pt2d)
        _same_grids(got, _contract(s, low, _fresh(pt2d)), "lower level")
        _same_grids(_contract(s, ct2d, pt2d), first, "back")
        got, builds = first, 5
    _same_grids(_contract(s, ct2d, pt2d), got, "hit")
    assert tlin.prepared_counts() == {"builds": builds, "hits": 1}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("scheme", ["bfv", "bgv", "ckks"])
def test_sharded_app_matmul_on_a_reused_plain2d(scheme, world):
    """sharded_app_matmul's ranks (each its own batch-block rows, no
    collective), twice over one Plain2d: the ranks' rows, in order, equal
    the whole grid's contraction on a fresh Plain2d; one build, the
    other calls hit (``rows`` is not part of the key)."""
    from troy_tpu_torch.parallel import sharding as sh
    s = _side(P, scheme)
    ct2d, pt2d = _grids(s, SEED - 10, 5, 2, 3)
    want = _contract(s, ct2d, _fresh(pt2d))
    tlin.reset_prepared_counts()
    for _ in range(2):
        got = []
        for r in range(world):
            mesh = sh.Mesh({"dp": sh.Axis(None, tuple(range(world)), r)},
                           torch.device("cpu"), "gloo")
            got += s.grid_words(sh.sharded_app_matmul(s.ev, mesh, ct2d,
                                                      pt2d))
        _same_grids(got, want, f"{world} ranks")
    assert tlin.prepared_counts() == {"builds": 1, "hits": 2 * world - 1}


def test_bgv_pack_outputs_decrypts_to_the_oracle():
    """BGV pack_outputs of 8 outputs two by two, by decryption: the inputs
    in coefficient form (the pre-shift needs it), matmul, pack (the
    coefficient-domain trace with kernel K''), the wire, decrypt."""
    s = _side(P, "bgv")
    rng = np.random.default_rng(SEED - 1)
    B, I, O = 6, 8, 40
    x, w = s.values(rng, (B, I)), s.values(rng, (I, O))
    h = tlin.MatmulHelper(B, I, O, s.n, objective=0, pack_lwe=True)
    assert h.input_block > 1
    x_ct = h.encrypt_inputs(s.encryptor(SEED - 2), s.ep, x)
    x_ct = tlin.Cipher2d([[s.ev.transform_from_ntt(c) for c in row]
                          for row in x_ct.data])
    y = h.pack_outputs(s.ev, s.ak, h.matmul(s.ev, x_ct,
                                            h.encode_weights(s.ep, w)))
    assert len(y.data[0]) == h._packed_count()
    y = h.deserialize_outputs(s.ev, s.ctx,
                              h.serialize_outputs(s.ev, s.ctx, y))
    got = h.decrypt_outputs(s.dp, s.dec, y)
    np.testing.assert_array_equal(got.astype(object) % s.t,
                                  _matmul_oracle(x, w, s.t))


@pytest.mark.parametrize("mod", [P, J], ids=["port", "troy_tpu"])
def test_ntt_form_pack_with_several_inputs_raises(mod):
    """CKKS outputs are in NTT form: a pack of more than one input per
    block needs the shift, which both packages refuse there."""
    s = _side(mod, "ckks")
    h = s.lin.MatmulHelper(2, 4, 5, s.n, objective=0, pack_lwe=True)
    assert h.input_block > 1
    rng = np.random.default_rng(SEED - 3)
    y = h.matmul(s.ev, h.encrypt_inputs(s.encryptor(SEED - 4), s.ep,
                                        s.values(rng, (2, 4))),
                 h.encode_weights(s.ep, s.values(rng, (4, 5))))
    with pytest.raises(ValueError, match="coefficient form"):
        h.pack_outputs(s.ev, s.ak, y)


def test_cipher2d_save_load_and_seeded_tiles():
    """Cipher2d.save / load across the packages, seed-compressed tiles
    included (c0 and the seed on the wire, c1 regenerated on load)."""
    port, ref = _side(P, "bfv"), _side(J, "bfv")
    rng = np.random.default_rng(SEED - 5)
    x = port.values(rng, (3, 4))
    blobs = {}
    for s in (port, ref):
        h = s.lin.MatmulHelper(3, 4, 2, s.n, objective=0, pack_lwe=False)
        grid = h.encode_inputs(s.ep, x).encrypt_symmetric(
            s.encryptor(SEED - 6), save_seed=True)
        blobs[s.port] = grid.save(s.ctx)
    assert blobs[True] == blobs[False]
    for s in (port, ref):
        other = blobs[not s.port]
        loaded = s.lin.Cipher2d.load(other, s.ctx)
        assert all(c.seed == 0 and c.size == 2 for row in loaded.data
                   for c in row)
        blobs[("words", s.port)] = s.grid_words(loaded)
    _same_grids(blobs[("words", True)], blobs[("words", False)],
                "loaded seeded grid")


def test_serialize_encoded_weights_bytes_and_load():
    port, ref = _side(P, "bfv"), _side(J, "bfv")
    rng = np.random.default_rng(SEED - 7)
    w = port.values(rng, (5, 6))
    raws = {}
    for s in (port, ref):
        h = s.lin.MatmulHelper(4, 5, 6, s.n, objective=0, pack_lwe=False)
        raws[s.port] = h.serialize_encoded_weights(h.encode_weights(s.ep, w))
    assert raws[True] == raws[False]
    h = tlin.MatmulHelper(4, 5, 6, port.n, objective=0, pack_lwe=False)
    back = h.deserialize_encoded_weights(raws[False], device="cpu")
    assert h.serialize_encoded_weights(back) == raws[True]


# the rows of tests/test_app.py test_matmul_block_search_matches_reference
# and test_conv2d_block_search_matches_reference
MATMUL_BLOCKS = {
    (64, 128, 256, 16384, 0, True): (64, 16, 16),
    (64, 128, 256, 16384, 1, True): (4, 16, 256),
    (64, 128, 256, 16384, 2, True): (16, 16, 64),
    (64, 128, 256, 16384, 0, False): (64, 8, 32),
    (4, 5, 6, 64, 0, False): (4, 5, 3),
    (2, 4, 5, 64, 0, True): (2, 2, 5),
    (128, 500, 1001, 16384, 1, False): (2, 8, 1001),
    (1, 2048, 1001, 8192, 0, True): (1, 16, 512),
}
CONV_BLOCKS = {
    (1, 56, 56, 3, 3, 64, 256, 16384, 0): (1, 56, 56, 1, 5),
    (1, 56, 56, 3, 3, 64, 256, 16384, 1): (1, 8, 8, 1, 256),
    (4, 16, 16, 5, 5, 3, 8, 4096, 0): (4, 16, 16, 1, 4),
    (1, 4, 4, 3, 3, 2, 2, 64, 0): (1, 4, 4, 2, 2),
    (2, 8, 8, 2, 2, 4, 4, 256, 2): (1, 8, 8, 2, 2),
}
SEARCHES = ([("matmul",) + k for k in MATMUL_BLOCKS]
            + [("conv",) + k for k in CONV_BLOCKS])


@pytest.mark.parametrize("case", SEARCHES,
                         ids=["-".join(map(str, c)) for c in SEARCHES])
def test_tiling_search(case):
    """Both searches, pow(slots, 0.33) included, pinned to the JAX app
    tests' rows and to troy_tpu's own choice."""
    kind, args = case[0], case[1:]
    if kind == "matmul":
        bs, ind, outd, slots, obj, pl = args
        get = lambda lin: (lambda h: (h.batch_block, h.input_block,
                                      h.output_block))(
            lin.MatmulHelper(bs, ind, outd, slots, objective=obj,
                             pack_lwe=pl))
        expect = MATMUL_BLOCKS[args]
    else:
        bs, H, W, kh, kw, ci, co, slots, obj = args
        get = lambda lin: (lambda h: (h.block_batch, h.block_height,
                                      h.block_width, h.block_in_channels,
                                      h.block_out_channels))(
            lin.Conv2dHelper(bs, H, W, kh, kw, ci, co, slots, objective=obj))
        expect = CONV_BLOCKS[args]
    assert get(tlin) == expect == get(jlin)
