"""The decrypt's last step folded into kernel A's last inverse pass (AXi:
kernel X's exact conversion to t, ``rns.ntt_inverse_decrypt_mod_t``; ACi:
kernel C's conversion to {t, gamma} with kernel E's rounding,
``rns.ntt_inverse_decrypt_scale_and_round``; csrc/ntt.cu
``troy_ntt_inverse_decrypt_bgv``, ``_bfv``) on the CPU, word for word
(tolerance 0):

  * each fused wrapper against the composition it replaces (A's inverse,
    then X, or C and E's rounding) and against its plain version, at
    n = 64 (the one pass over whole rows), 1024 and 4096 (two passes),
    1 and 3 components, k = 1, 3 and 5 limbs; BGV with the inverse
    correction factors 1, 7 and t - 1, BFV with t of 20, 41 and 59 bits
    and a t that does not batch (2^41);
  * the port's ``Decryptor.decrypt`` and ``decrypt_many`` of BFV and BGV
    against troy_tpu's at n = 1024, at the first data level and one level
    down, BGV with a correction factor other than 1;
  * the route: the fused call on A's route, A's or J's inverse and the
    standalone kernels on J's (``use_mxu=True``) and where one block of
    the fused pass cannot hold the level's limbs (the card's plan,
    emulated here: ``rns.decrypt_plan`` asks the library on the card and
    sets no cap on the CPU);
  * the wrappers' refusals (J's tables, a pointwise view, a wrong shape,
    too many limbs);
  * a plain-torch emulation of the fused pass's plan (csrc/ntt.cu
    plan_inverse without the special tile, its caps and needs read from
    the source; test_torch_cuda.py holds the library's plans to the same
    table) and addressing (block, tile and word maps): which source words
    each tile loads and where each finished coefficient is stored, held to
    the plain version at the plan's column set and at every other that
    holds the rows. The kernel cannot run here; this guards its addressing
    on the CPU.

Random words below each limb's modulus and random key words from numpy
seeds.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from test_torch_inverse_divide import _inverse_rounds

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch.ops import ntt, rns
from troy_tpu_torch.ops import u64ops as u
from troy_tpu_torch.utils.rns import make_rns_tool

torch.set_num_threads(2)

SEED = 8181
CSRC = Path(ntt.__file__).resolve().parents[1] / "csrc"


def _words(rng, moduli, lead, n):
    return np.concatenate([rng.integers(0, q, size=lead + (1, n),
                                        dtype=np.uint64) for q in moduli],
                          axis=-2)


def _t(words):
    return interop.to_torch(words, "cpu")


_TABLES = {}


def _level(n, k, t):
    """(tables of k 50-bit primes at n, the BGV converter to t, the BFV
    tool with t), made once."""
    key = (n, k, t)
    if key not in _TABLES:
        q = tuple(int(m) for m in P.CoeffModulus.create(n, [50] * k))
        tables = ntt.RnsNttTables.from_moduli(n, q, "cpu", use_mxu=False)
        host = make_rns_tool(n, q, t)
        bsk = ntt.RnsNttTables.from_moduli(n, host.base_Bsk.values, "cpu",
                                           use_mxu=False)
        _TABLES[key] = (tables, rns.ExactConverter.build(host.conv_q_to_t,
                                                         "cpu"),
                        rns.DeviceRnsTool.build(host, tables, bsk))
    return _TABLES[key]


def _batching(n, bits):
    return int(P.PlainModulus.batching(n, bits))


@pytest.mark.parametrize("comps", [1, 3])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_bgv_fused_decrypt_is_the_composition(n, k, comps):
    t = _batching(n, 20)
    tables, conv, _ = _level(n, k, t)
    x = _t(_words(np.random.default_rng(SEED + n + k + comps), tables.values,
                  (comps,), n))
    for inv_cf in (1, 7, t - 1):
        got = rns.ntt_inverse_decrypt_mod_t(x, tables, conv, inv_cf)
        assert got.shape == (comps, n)
        want = rns.decrypt_mod_t(ntt.rns_ntt_inverse(x, tables), conv, inv_cf)
        assert torch.equal(got, want), inv_cf
        assert torch.equal(got, rns.ntt_inverse_decrypt_mod_t_plain(
            x, tables, conv, inv_cf))
    # one phase, no leading axis
    assert torch.equal(rns.ntt_inverse_decrypt_mod_t(x[0], tables, conv, 7),
                       rns.decrypt_mod_t(ntt.rns_ntt_inverse(x[0], tables),
                                         conv, 7))


# t of 20, 41 and 59 bits (batching) and 2^41 (troy's app benchmark's,
# which does not batch)
T_KINDS = {"t20": lambda n: _batching(n, 20), "t41": lambda n: _batching(
    n, 41), "t59": lambda n: _batching(n, 59), "t2^41": lambda n: 1 << 41}


@pytest.mark.parametrize("t_kind", list(T_KINDS))
@pytest.mark.parametrize("comps", [1, 3])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_bfv_fused_decrypt_is_the_composition(n, k, comps, t_kind):
    _, _, tool = _level(n, k, T_KINDS[t_kind](n))
    x = _t(_words(np.random.default_rng(SEED + 7 * n + k + comps),
                  tool.q.values, (comps,), n))
    got = rns.ntt_inverse_decrypt_scale_and_round(x, tool)
    assert got.shape == (comps, n)
    assert torch.equal(got, rns.decrypt_scale_and_round(
        ntt.rns_ntt_inverse(x, tool.q), tool))
    assert torch.equal(got, rns.ntt_inverse_decrypt_scale_and_round_plain(
        x, tool))


# --------------------------------------------------------------------------
# the decryptor against troy_tpu's, and its route
# --------------------------------------------------------------------------

_CTX = {}


def _ctxs(scheme, n=1024, bits=(40, 40, 40, 40), use_mxu=None):
    """(port context, troy_tpu context or None) at n, t =
    PlainModulus.batching(n, 20)."""
    key = (scheme, n, bits, use_mxu)
    if key not in _CTX:
        out = []
        for mod in (P, J) if use_mxu is None else (P,):
            parms = mod.EncryptionParameters(
                scheme=getattr(mod.SchemeType, scheme),
                poly_modulus_degree=n,
                coeff_modulus=tuple(mod.CoeffModulus.create(n, list(bits))),
                plain_modulus=mod.PlainModulus.batching(n, 20))
            on = ({"device": "cpu", "use_mxu": use_mxu} if mod is P
                  else {"use_mxu": False})
            out.append(mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                     **on))
        _CTX[key] = (out + [None])[:2]
    return _CTX[key]


def _cts(ctx, rng, level, count, cf=1):
    """count size-2 coefficient-form (BFV) or NTT-form (BGV) ciphertexts of
    random words at a level, as (words, port ciphertexts)."""
    cd = ctx.get_context_data(level)
    words = [_words(rng, cd.coeff_values, (2,), cd.n) for _ in range(count)]
    bgv = ctx.scheme == P.SchemeType.bgv
    return words, [interop.ciphertext(w, level, bgv, "cpu",
                                      correction_factor=cf) for w in words]


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_decrypt_matches_troy_tpu(scheme):
    """decrypt and decrypt_many (3 ciphertexts) at the first data level
    and one level down; BGV with the correction factors 1 and 3."""
    pctx, jctx = _ctxs(scheme)
    rng = np.random.default_rng(SEED + len(scheme))
    key = pctx.key_context_data
    sk = _words(rng, key.coeff_values, (), key.n)
    pdecr = P.Decryptor(pctx, interop.secret_key(sk, "cpu"))
    jdecr = J.Decryptor(jctx, J.SecretKey(data=jnp.asarray(sk)))
    bgv = scheme == "bgv"
    for level in (pctx.first_level, pctx.first_level + 1):
        for cf in ((1, 3) if bgv else (1,)):
            words, cts = _cts(pctx, rng, level, 3, cf)
            jcts = [J.Ciphertext(data=jnp.asarray(w), level=level,
                                 is_ntt_form=bgv, correction_factor=cf)
                    for w in words]
            got = [pdecr.decrypt(c) for c in cts[:1]] + pdecr.decrypt_many(
                cts)
            want = [jdecr.decrypt(c) for c in jcts[:1]] + jdecr.decrypt_many(
                jcts)
            for g, w in zip(got, want):
                assert np.array_equal(interop.words(g),
                                      np.asarray(w.data)), (level, cf)


def _count_routes(monkeypatch):
    calls = {}
    for name in ("ntt_inverse_decrypt_mod_t",
                 "ntt_inverse_decrypt_scale_and_round", "decrypt_mod_t",
                 "decrypt_scale_and_round"):
        fn = getattr(rns, name)
        calls[name] = 0

        def wrapped(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(rns, name, wrapped)
    return calls


# A's route; J's; and n = 512 with 6 data limbs, one more than a block of
# the fused pass holds there on the card (tiles of 512 words and 1024
# twiddles)
ROUTES = {"a": (2048, (40, 40, 40, 40), None),
          "j": (2048, (40, 40, 40, 40), True),
          "too_many_limbs": (512, (30,) * 7, None)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_decrypt_route(scheme, route, monkeypatch):
    """One fused call a decrypt and a decrypt_many on A's route, none of
    the standalone conversions; the composition elsewhere, chosen by
    shape (``rns.decrypt_fused``, the card's plan emulated) before any
    call. On the CPU itself no plan caps the limbs."""
    n, bits, use_mxu = ROUTES[route]
    pctx, _ = _ctxs(scheme, n, bits, use_mxu)
    cd = pctx.first_context_data
    bfv = scheme == "bfv"
    assert rns.decrypt_fused(cd.ntt, bfv) == (route != "j")
    monkeypatch.setattr(rns, "decrypt_plan", _card_plan)
    fused = route == "a"
    assert rns.decrypt_fused(cd.ntt, bfv) == fused
    rng = np.random.default_rng(SEED + n)
    key = pctx.key_context_data
    dec = P.Decryptor(pctx, interop.secret_key(
        _words(rng, key.coeff_values, (), n), "cpu"))
    _, cts = _cts(pctx, rng, pctx.first_level, 2, 1 if bfv else 5)
    calls = _count_routes(monkeypatch)
    one = dec.decrypt(cts[0])
    many = dec.decrypt_many(cts)
    names = ("ntt_inverse_decrypt_scale_and_round", "decrypt_scale_and_round"
             ) if bfv else ("ntt_inverse_decrypt_mod_t", "decrypt_mod_t")
    assert calls[names[0]] == (2 if fused else 0), calls
    assert calls[names[1]] == (0 if fused else 2), calls
    assert sum(calls.values()) == 2, calls
    assert torch.equal(one.data, many[0].data)


def test_fused_decrypt_refuses_what_a_block_cannot_take(monkeypatch):
    n = 2048
    moduli = [int(m) for m in P.CoeffModulus.create(n, [40, 40])]
    t = _batching(n, 20)
    host = make_rns_tool(n, tuple(moduli), t)
    on_a = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    on_j = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=True)
    conv = rns.ExactConverter.build(host.conv_q_to_t, "cpu")
    bsk = ntt.RnsNttTables.from_moduli(n, host.base_Bsk.values, "cpu",
                                       use_mxu=False)
    tool = rns.DeviceRnsTool.build(host, on_a, bsk)
    tool_j = rns.DeviceRnsTool.build(host, on_j, ntt.RnsNttTables.from_moduli(
        n, host.base_Bsk.values, "cpu", use_mxu=True))
    x = torch.zeros((3, 2, n), dtype=torch.int64)
    bgv = lambda x, tables: rns.ntt_inverse_decrypt_mod_t(x, tables, conv,
                                                          3)
    bfv = lambda x, tables: rns.ntt_inverse_decrypt_scale_and_round(
        x, tool_j if tables is on_j else tool)
    for fn in (bgv, bfv):
        with pytest.raises(ValueError, match="no transform on A"):
            fn(x, on_j)
        for bad in (x[:, :1], x[..., :64], x[0, 0]):
            with pytest.raises(ValueError, match="do not fit"):
                fn(bad, on_a)
    with pytest.raises(ValueError, match="no transform on A"):
        bgv(x, on_a.pointwise(n))
    small = rns.ExactConverter.build(make_rns_tool(
        n, tuple(moduli[:1]), t).conv_q_to_t, "cpu")
    with pytest.raises(ValueError, match="do not fit"):
        rns.ntt_inverse_decrypt_mod_t(x, on_a, small)
    # 6 limbs at n = 512: one more than a block holds (the card's plan,
    # emulated; the CPU's plain version takes them)
    n, k = 512, 6
    wide = tuple(int(m) for m in P.CoeffModulus.create(n, [30] * k))
    host = make_rns_tool(n, wide, _batching(n, 20))
    tables = ntt.RnsNttTables.from_moduli(n, wide, "cpu", use_mxu=False)
    tool = rns.DeviceRnsTool.build(host, tables, ntt.RnsNttTables.from_moduli(
        n, host.base_Bsk.values, "cpu", use_mxu=False))
    x = torch.zeros((1, k, n), dtype=torch.int64)
    conv6 = rns.ExactConverter.build(host.conv_q_to_t, "cpu")
    assert rns.ntt_inverse_decrypt_mod_t(x, tables, conv6).shape == (1, n)
    monkeypatch.setattr(rns, "decrypt_plan", _card_plan)
    with pytest.raises(ValueError, match="cannot hold 6 limbs"):
        rns.ntt_inverse_decrypt_mod_t(x, tables, conv6)
    with pytest.raises(ValueError, match="cannot hold 6 limbs"):
        rns.ntt_inverse_decrypt_scale_and_round(x, tool)
    assert not rns.decrypt_fused(tables, True)
    assert rns.decrypt_fused(tables.slice(0, 5), False)


# --------------------------------------------------------------------------
# the fused pass's addressing, emulated
# --------------------------------------------------------------------------

def _source_int(name, text):
    expr = re.search(rf"constexpr int {name} = ([0-9 <]+);", text).group(1)
    parts = [int(v) for v in expr.split("<<")]
    return parts[0] << parts[1] if len(parts) == 2 else parts[0]


def _constants():
    """csrc/ntt.cu's caps of the fused last pass and kDecryptNeeds (AXi's,
    then ACi's: special, acc, row_consts, block_consts, min_cols,
    min_blocks, max_log_words), with decrypt.cuh's kRoundConsts."""
    src = (CSRC / "ntt.cu").read_text()
    c = {name: _source_int(name, src) for name in (
        "kLogTile", "kSplitLogN", "kInverseThreads", "kInverseSmem")}
    round_consts = _source_int("kRoundConsts",
                               (CSRC / "decrypt.cuh").read_text())
    body = re.search(r"kDecryptNeeds\[2\] = \{(.*?)\};", src, re.S).group(1)
    c["needs"] = [tuple(eval(v.replace("kRoundConsts", str(round_consts)))
                        for v in group.split(","))
                  for group in re.findall(r"\{([^{}]*)\}", body)]
    return c


C = _constants()
AXI, ACI = C["needs"]


def _plan(comps, k, log_n, need, log_cols=None):
    """csrc/ntt.cu plan_inverse of a fused decrypt pass (``need``: AXI or
    ACI): (log_line, log_cols, group, log2 of a tile's threads, blocks). A
    block holds `group` rows; group < k where the caps let no block hold
    them all. ``log_cols``: that column set alone (group 0 if A's lines
    have fewer), for the addressing test."""
    special, acc, row_consts, block_consts, min_cols, min_blocks, \
        max_log_words = need
    log_line, max_cols = log_n, 0
    if log_n >= C["kSplitLogN"]:
        a = log_n // 2
        log_line, max_cols = a, max(0, min(C["kLogTile"] - a, log_n - a))
    lo = min(max_cols, min_cols)
    hi = min(max_cols, max(lo, max_log_words - log_line))
    if log_cols is not None:
        if log_cols > max_cols:
            return (log_line, log_cols, 0, 0, 0)
        hi = lo = log_cols
    plan = whole = None
    for cols in range(hi, lo - 1, -1):
        log_words = log_line + cols
        words = 1 << log_words
        tile = words + (2 << log_line)
        log_tt = max(0, log_words - 3)
        group = k
        while group > 1 and (
                group > (C["kInverseThreads"] >> log_tt) - special
                or 8 * ((group + special) * tile
                        + group * (words * acc + row_consts)
                        + block_consts) > C["kInverseSmem"]):
            group -= 1
        blocks = (comps * -(-k // group)) << (log_n - log_words)
        plan = (log_line, cols, group, log_tt, blocks)
        if group == k:
            if blocks >= min_blocks:
                return plan
            whole = plan
    return whole or plan


def _card_plan(tables, bfv):
    """``rns.decrypt_plan`` as the card answers it, emulated."""
    return _plan(1, tables.k, tables.log_n, ACI if bfv else AXI)


def test_plan_mirror_reads_the_source():
    """The emulation's caps and needs, read from csrc/ntt.cu, are the ones
    the fused pass was tuned with: one-column sets allowed, 96 blocks,
    tiles of 512 words at most; X's 6 constants a limb and 5 others, C's 5
    a limb and 6 others with E's 9; no special tile, no accumulator."""
    assert (C["kLogTile"], C["kSplitLogN"], C["kInverseThreads"],
            C["kInverseSmem"]) == (10, 10, 512, 64 << 10)
    assert AXI == (0, 0, 6, 5, 0, 96, 9)
    assert ACI == (0, 0, 5, 15, 0, 96, 9)


# (comps, k, log2 n) -> the plans of AXi's and ACi's pass (one plan: the
# same for both), the same table as test_torch_cuda.py's DECRYPT_PLANS,
# which holds the library to it
DECRYPT_PLANS = {(1, 5, 14): (7, 0, 5, 4, 128), (3, 5, 14): (7, 2, 5, 6, 96),
                 (52, 2, 14): (7, 2, 2, 6, 1664),
                 (1, 15, 15): (7, 1, 15, 5, 128),
                 (1, 21, 14): ((7, 0, 20, 4, 256), (7, 0, 21, 4, 128)),
                 (1, 5, 9): (9, 0, 5, 6, 1), (1, 6, 9): (9, 0, 5, 6, 2),
                 (1, 2, 18): (9, 0, 2, 6, 512)}


def test_decrypt_plans():
    """The rule of AFi's plan without the special tile: all k rows in one
    block, the widest column set (tiles of 512 words at most) with 96
    blocks, else the narrowest (one column: 128 blocks at a single decrypt
    at n = 16384); SEAL's 15 limbs at n = 32768 in one block; 6 limbs of
    whole rows at n = 512 in two blocks; at n = 16384, 21 limbs in one
    block of ACi's and two of AXi's; within the card's limits (1024
    threads, 227 KB of shared memory)."""
    for (comps, k, log_n), plans in DECRYPT_PLANS.items():
        if not isinstance(plans[0], tuple):
            plans = (plans, plans)
        assert (_plan(comps, k, log_n, AXI), _plan(comps, k, log_n, ACI)
                ) == plans, (comps, k, log_n)
    for need in (AXI, ACI):
        for comps, k, log_n in [(1, 20, 14), (2, 10, 17), (1, 1, 1),
                                (52, 2, 14), (1, 5, 18), (1, 1, 24)]:
            log_line, cols, group, log_tt, blocks = _plan(comps, k, log_n,
                                                          need)
            assert group == k
            threads = group << log_tt
            words = 1 << (log_line + cols)
            smem = 8 * (group * (words + (2 << log_line) + need[2])
                        + need[3])
            assert threads <= 1024 and smem <= 232448
            assert words <= 8 << log_tt          # a tile's loads a thread
            assert blocks == comps << (log_n - log_line - cols)


def _emulated_decrypt(v, tables, finish, need, log_cols=None):
    """The fused pass's loads and stores: block b = (comp, column set)
    holds columns first .. first + 2^log_cols of rows comp k + t (tile t,
    limb t); word f of a tile is column l = f mod 2^log_cols, line index
    i = f >> log_cols, at row offset first + l + (i << (log_n -
    log_line)); coefficient f's k lazy words go through ``finish`` (k, N)
    -> (N) and land at that offset of output row comp (the plan of
    ``need``). v (s, k, n): the lazy words the butterflies leave (below
    2q), n^-1 not yet applied."""
    s, k, n = v.shape
    log_n = n.bit_length() - 1
    log_line, cols, group, _, blocks = _plan(s, k, log_n, need, log_cols)
    assert group == k
    log_words = log_line + cols
    log_sets = log_n - log_words
    b = torch.arange(blocks).unsqueeze(1)
    f = torch.arange(1 << log_words)
    first = (b & ((1 << log_sets) - 1)) << cols
    comp = b >> log_sets
    l, i = f & ((1 << cols) - 1), f >> cols
    # the tile's line l is the strided pass's column first + l of the row
    # seen as a (2^log_line, n / 2^log_line) matrix
    offset = first + l + (i << (log_n - log_line))
    assert torch.equal(offset % (n >> log_line), (first + l).expand_as(
        offset))
    at = (comp << log_n) + offset
    assert torch.equal(torch.sort(at.flatten()).values,
                       torch.arange(s << log_n)), \
        "the fused pass does not store every coefficient once"
    rows = (comp.unsqueeze(-1) * k + torch.arange(k)) << log_n
    loads = rows + offset.unsqueeze(-1)                # (blocks, words, k)
    assert torch.equal(torch.sort(loads.flatten()).values,
                       torch.arange((s * k) << log_n)), \
        "the tiles do not load every source word once"
    words = v.flatten()[loads.reshape(-1, k)].T              # (k, N)
    out = torch.empty(s << log_n, dtype=torch.int64)
    out[at.flatten()] = finish(words)
    return out.reshape(s, n)


# n = 64: one pass over whole rows (compiled: 2^6-word lines); 512: one
# pass, run time; 1024-16384: compiled; 262144: run time (2^9-word
# lines); at every column set whose block holds the k rows
@pytest.mark.parametrize("n,k,s", [(64, 3, 2), (512, 5, 1), (1024, 3, 3),
                                   (4096, 5, 1), (16384, 5, 1),
                                   (16384, 2, 52), (262144, 1, 1)])
def test_fused_pass_addressing_matches_the_plain_version(n, k, s):
    log_n = n.bit_length() - 1
    t = _batching(n, 20 if n <= 16384 else 30)
    tables, conv, tool = _level(n, k, t)
    rng = np.random.default_rng(SEED + n + k + s)
    v = _t(_words(rng, [2 * q for q in tables.values], (s,), n))
    col = lambda x: x.reshape(-1, 1)
    reduced = u.reduce_2q(u.mul_mod_shoup_lazy(
        v, col(tables.inv_degree), col(tables.inv_degree_shoup),
        col(tables.q)), col(tables.q))
    # the kernel's finish: n^-1 folded into the punctured inverses, the
    # lazy words straight into their Shoup products
    folded_x = rns.ExactConverter(rns.fold_inverse_degree(conv.consts,
                                                          tables), k, t)
    scaled = tool.q_to_t_gamma_scaled
    folded_c = rns.DeviceConverter(rns.fold_inverse_degree(scaled.consts,
                                                           tables), k, 2)
    exact = (lambda w: rns.exact_convert_plain(w, folded_x, 7)[0], AXI)
    round_ = (lambda w: rns.behz_decrypt_round_plain(
        rns.fast_convert_plain(w, folded_c), tool), ACI)
    want_x = rns.exact_convert_plain(reduced, conv, 7)[:, 0]
    want_c = rns.decrypt_scale_and_round_plain(reduced, tool)
    max_cols = 0 if log_n < C["kSplitLogN"] else min(
        C["kLogTile"] - log_n // 2, log_n - log_n // 2)
    holding = [c for c in range(max_cols + 1)
               if _plan(s, k, log_n, AXI, c)[2] == k]
    assert _plan(s, k, log_n, AXI)[1] in holding
    for cols in holding:
        assert torch.equal(_emulated_decrypt(v, tables, *exact, cols),
                           want_x)
        assert torch.equal(_emulated_decrypt(v, tables, *round_, cols),
                           want_c)
    if n <= 4096:
        # the whole fused decrypt: A's inverse rounds (no n^-1), then the
        # emulated finish, against the plain version of each wrapper
        x = _t(_words(rng, tables.values, (s,), n))
        lazy = _inverse_rounds(x, tables)
        assert torch.equal(_emulated_decrypt(lazy, tables, *exact),
                           rns.ntt_inverse_decrypt_mod_t_plain(x, tables,
                                                               conv, 7))
        assert torch.equal(
            _emulated_decrypt(lazy, tables, *round_),
            rns.ntt_inverse_decrypt_scale_and_round_plain(x, tool))
