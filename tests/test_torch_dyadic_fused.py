"""Kernel B after its redesign (troy_tpu_torch/ops/ntt.py ``dyadic_mac``,
``dyadic_mac_batched``, ``dyadic_convolve``; csrc/dyadic_mac.cu) against
troy_tpu, word for word (tolerance 0), on the CPU.

  * the port's ``_dyadic_convolution`` (one B launch for every output
    component on a card) against troy_tpu/evaluator.py:60
    ``_dyadic_convolution`` for sizes 2 and 3 a side, the square (b is a),
    a leading batch axis and lazy words below 4q;
  * the key switch's inner product (``_switch_key_inner_product``: B reads
    the level's rows of the key in place, the level's primes and the
    special row) at the first level and every level below it, in the
    single, hoisted and batched shapes, against troy_tpu/evaluator.py:262
    ``_switch_key_inner_product``;
  * the decrypt phase c0 + c1 s + ... (c0 the addend of B's sum, the
    secret key's powers read at the level's rows in place) against
    troy_tpu/decryptor.py:36 ``_phase_ntt_core`` and :71
    ``_phase_ntt_many``;
  * the kernels' addressing emulated: each wrapper's launch is recorded
    (no card here) and csrc/dyadic_mac.cu's grid (coefficient pairs, the
    component chunk above them, the row, the group; the convolution's
    term ranges) is walked over the operands' storage with the pitches
    the wrapper passed, and must write every output word once with the
    plain version's words;
  * the wrappers' refusals.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu import decryptor as jdec
from troy_tpu import evaluator as jev

import troy_tpu_torch as P
from troy_tpu_torch import _kernels, interop
from troy_tpu_torch import decryptor as pdec
from troy_tpu_torch import evaluator as pev
from troy_tpu_torch.ops import ntt
from troy_tpu_torch.ops import u64ops as u

torch.set_num_threads(2)

SEED = 2122
SOURCE = (Path(__file__).resolve().parent.parent / "troy_tpu_torch" / "csrc"
          / "dyadic_mac.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


# csrc/dyadic_mac.cu's block size, log2 of a block's words, the most terms
# a batch
THREADS, LOG_BLOCK_WORDS, TERM_BATCH = (
    _constant(c) for c in ("kThreads", "kLogBlockWords", "kTermBatch"))

_CTX = {}


def _ctxs(scheme, n, bits):
    key = (scheme, n, tuple(bits))
    if key not in _CTX:
        out = []
        for mod in (P, J):
            extra = {} if scheme == "ckks" else {
                "plain_modulus": mod.PlainModulus.batching(n, 20)}
            parms = mod.EncryptionParameters(
                scheme=getattr(mod.SchemeType, scheme),
                poly_modulus_degree=n,
                coeff_modulus=tuple(mod.CoeffModulus.create(n, bits)),
                **extra)
            on = {"device": "cpu"} if mod is P else {}
            out.append(mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                     **on))
        _CTX[key] = tuple(out)
    return _CTX[key]


def _words(rng, bounds, lead, n):
    return np.stack([rng.integers(0, b, size=lead + (n,), dtype=np.uint64)
                     for b in bounds], axis=-2)


def _t(x):
    return interop.to_torch(np.ascontiguousarray(x), "cpu")


# --------------------------------------------------------------------------
# against troy_tpu
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("s1,s2,batch", [(2, 2, None), (2, 3, None),
                                         (3, 2, None), (3, 3, None),
                                         (2, 2, 3), (3, 2, 2), ("sq", 2, None),
                                         ("sq", 3, None), ("sq", 2, 2)])
def test_convolution_matches_troy_tpu(s1, s2, batch, lazy):
    n = 256
    pc, jc = _ctxs("bgv", n, [50, 40, 40, 50])
    pd, jd = pc.first_context_data, jc.first_context_data
    q = pd.coeff_values
    bounds = [4 * v for v in q] if lazy else q
    rng = np.random.default_rng(SEED + 7 * (s2 + (batch or 0)) + lazy)
    square = s1 == "sq"
    s1 = s2 if square else s1
    lead = () if batch is None else (batch,)
    a = _words(rng, bounds, lead + (s1,), n)
    b = a if square else _words(rng, bounds, lead + (s2,), n)
    at = _t(a)
    got = pev._dyadic_convolution(at, at if square else _t(b), pd.ntt)
    assert got.shape == lead + (s1 + s2 - 1, len(q), n)
    for z in range(batch or 1):
        az, bz = (a[z], b[z]) if batch else (a, b)
        want = jev._dyadic_convolution([jnp.asarray(v) for v in az],
                                       [jnp.asarray(v) for v in bz], jd.ntt)
        gz = got[z] if batch else got
        for m, w in enumerate(want):
            np.testing.assert_array_equal(interop.to_numpy(gz[m]),
                                          np.asarray(w))


def _levels(ctx):
    return range(ctx.first_level, ctx.last_level + 1)


@pytest.mark.parametrize("scheme", ["bfv", "ckks"])
def test_key_switch_inner_product_matches_troy_tpu(scheme):
    """Every level of a 5-prime chain (4 data primes and the special one):
    the single shape, the hoisted stack of keys (k, m, 2, k + 1, n) and
    the batched fold (m targets) against troy_tpu's inner product per
    target and key."""
    n = 128
    pc, jc = _ctxs(scheme, n, [50, 40, 40, 40, 50])
    pkd, jkd = pc.key_context_data, jc.key_context_data
    kf = len(pkd.coeff_values)
    rng = np.random.default_rng(SEED + len(scheme))
    keys = [_words(rng, pkd.coeff_values, (kf - 1, 2), n) for _ in range(2)]
    for level in _levels(pc):
        pd, jd = pc.get_context_data(level), jc.get_context_data(level)
        k = pd.limbs
        used = list(pkd.coeff_values[:k]) + [pkd.coeff_values[-1]]
        t_hats = [_words(rng, used, (k,), n) for _ in range(2)]

        def want(t_hat, key):
            return np.stack([np.asarray(w) for w in
                             jev._switch_key_inner_product(
                                 jnp.asarray(t_hat), jnp.asarray(key), jd,
                                 jkd)])

        got = pev._switch_key_inner_product(_t(t_hats[0]), _t(keys[0]), pd,
                                            pkd)
        np.testing.assert_array_equal(interop.to_numpy(got),
                                      want(t_hats[0], keys[0]))
        batched = pev._switch_key_inner_product(_t(np.stack(t_hats)),
                                                _t(keys[0]), pd, pkd)
        hoisted = pev._switch_key_inner_product(
            _t(t_hats[0]), torch.stack([pev._key_rows(_t(key), k, kf)
                                        for key in keys], dim=1), pd, pkd)
        for i in range(2):
            np.testing.assert_array_equal(interop.to_numpy(batched[i]),
                                          want(t_hats[i], keys[0]))
            np.testing.assert_array_equal(interop.to_numpy(hoisted[i]),
                                          want(t_hats[0], keys[i]))


@pytest.mark.parametrize("ntt_form", [False, True])
@pytest.mark.parametrize("size", [2, 3])
def test_decrypt_phase_matches_troy_tpu(size, ntt_form):
    """c0 + c1 s + ... at every level (the powers' rows of the level read
    in place) and for a batch of 3, against troy_tpu's phases on the same
    words and powers."""
    n = 128
    pc, jc = _ctxs("bfv", n, [50, 40, 40, 50])
    pkd = pc.key_context_data
    rng = np.random.default_rng(SEED + size + 2 * ntt_form)
    powers = _words(rng, pkd.coeff_values, (size - 1,), n)
    for level in _levels(pc):
        pd, jd = pc.get_context_data(level), jc.get_context_data(level)
        data = _words(rng, pd.coeff_values, (3, size), n)
        jpowers = tuple(jnp.asarray(p) for p in powers)
        got = pdec._phase_ntt_core(_t(data[0]), _t(powers), pd, ntt_form)
        want = jdec._phase_ntt_core(jnp.asarray(data[0]), jpowers, jd,
                                    ntt_form)
        np.testing.assert_array_equal(interop.to_numpy(got),
                                      np.asarray(want))
        got = pdec._phase_ntt_many(_t(data), _t(powers), pd, ntt_form)
        want = jdec._phase_ntt_many(jnp.asarray(data), jpowers, jd,
                                    ntt_form)
        np.testing.assert_array_equal(interop.to_numpy(got),
                                      np.asarray(want))


# --------------------------------------------------------------------------
# the kernels' addressing, emulated
# --------------------------------------------------------------------------

def _storage(x: torch.Tensor) -> torch.Tensor:
    """Every word of x's storage, as a flat view from its start."""
    return torch.as_strided(x, (x.untyped_storage().nbytes() // 8,), (1,),
                            0)


def _pairs(n):
    """The first word of each live thread's pair, block by block: log2 of
    the coefficient blocks and the words (csrc/dyadic_mac.cu)."""
    log_n = n.bit_length() - 1
    lc = max(log_n - LOG_BLOCK_WORDS, 0)
    i = 2 * torch.arange((1 << lc) * THREADS)
    return lc, i[i < n]


def _reduce_store(out_flat, at, lo, hi, q, cr_lo, cr_hi, written):
    out_flat[at] = u.barrett_reduce_128(lo, hi, q, cr_lo, cr_hi)
    assert not bool(written[at].any()), "a word written twice"
    written[at] = True


def _emulate_mac(out, a, b, add, terms, comps, groups, rows, log_n, a_term,
                 a_group, b_term, b_comp, b_group, b_last, add_comp,
                 add_group, o_comp, o_group, q, cr_lo, cr_hi):
    """troy_dyadic_mac: block (pairs | chunk on x, row y, group z), CC =
    2 components a chunk where comps > 1 and terms > 1, the terms in as
    few equal batches of at most TERM_BATCH as they fit, the last row of
    b read at b_last."""
    n = 1 << log_n
    assert n >= 2 and terms <= 64 and b_last >= rows - 1
    for v in (a_term, a_group, b_term, b_comp, b_group, add_comp, add_group,
              o_comp, o_group):
        assert v % 2 == 0
    for x in (out, a, b, add):
        assert x is None or x.data_ptr() % 16 == 0
    A, B, O = _storage(a), _storage(b), _storage(out)
    D = None if add is None else _storage(add)
    written = torch.zeros(O.numel(), dtype=torch.bool)
    cc = 2 if comps > 1 and terms > 1 else 1
    batches = -(-terms // TERM_BATCH)
    tb = -(-terms // batches)
    lc, i = _pairs(n)
    i = torch.cat([i, i + 1])                  # each thread's two words
    for chunk in range((comps + cc - 1) // cc):
        c0 = chunk * cc
        for r in range(rows):
            brow = b_last if r == rows - 1 else r
            for g in range(groups):
                at = r * n + i
                for c in range(cc):
                    if c0 + c >= comps:
                        continue
                    if add is None:
                        lo = hi = torch.zeros_like(i)
                    else:
                        lo = D[add.storage_offset() + g * add_group
                               + (c0 + c) * add_comp + at]
                        hi = torch.zeros_like(lo)
                    for j0 in range(0, terms, tb):
                        for j in range(j0, min(terms, j0 + tb)):
                            av = A[a.storage_offset() + g * a_group
                                   + j * a_term + at]
                            bv = B[b.storage_offset() + g * b_group
                                   + (c0 + c) * b_comp + j * b_term
                                   + brow * n + i]
                            plo, phi = u.mul128(av, bv)
                            lo, hi = u.add_u128(lo, hi, plo, phi)
                    _reduce_store(O, out.storage_offset() + g * o_group
                                  + (c0 + c) * o_comp + at, lo, hi, q[r],
                                  cr_lo[r], cr_hi[r], written)
    assert int(written.sum()) == comps * groups * rows * n


def _emulate_convolve(out, a, b, square, batch, s1, s2, R, log_n, a_batch,
                      b_batch, q, cr_lo, cr_hi):
    """troy_dyadic_convolve: block (pairs x, row y, product z), each
    output component m the sum over s in [max(0, m - s2 + 1), min(s1 - 1,
    m)] of a[s] b[m - s]; a square reads b as a."""
    n = 1 << log_n
    assert n >= 2 and a_batch % 2 == 0 and b_batch % 2 == 0
    assert not square or (a is b or a.data_ptr() == b.data_ptr())
    A, B, O = _storage(a), _storage(b), _storage(out)
    written = torch.zeros(O.numel(), dtype=torch.bool)
    row = R * n
    _, i = _pairs(n)
    i = torch.cat([i, i + 1])
    for z in range(batch):
        for r in range(R):
            at = r * n + i
            for m in range(s1 + s2 - 1):
                lo = hi = torch.zeros_like(i)
                for s in range(max(0, m - s2 + 1), min(s1 - 1, m) + 1):
                    av = A[a.storage_offset() + z * a_batch + s * row + at]
                    bv = B[b.storage_offset() + z * b_batch + (m - s) * row
                           + at]
                    plo, phi = u.mul128(av, bv)
                    lo, hi = u.add_u128(lo, hi, plo, phi)
                _reduce_store(O, out.storage_offset()
                              + z * (s1 + s2 - 1) * row + m * row + at, lo,
                              hi, q[r], cr_lo[r], cr_hi[r], written)
    assert int(written.sum()) == batch * (s1 + s2 - 1) * R * n


@pytest.fixture
def emulated(monkeypatch):
    """The wrappers take their kernel path on the CPU's tensors, and each
    launch runs its emulation; the launches are listed as (entry point,
    arguments)."""
    seen = []
    emulators = {"troy_dyadic_mac": _emulate_mac,
                 "troy_dyadic_convolve": _emulate_convolve}

    def launch(entry, device, *args):
        seen.append((entry, args))
        emulators[entry](*args)

    monkeypatch.setattr(_kernels, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(_kernels, "launch", launch)
    monkeypatch.setattr(_kernels, "check_operand", lambda *a, **kw: None)
    return seen


def _tables(n, k, bits=50):
    moduli = [int(v) for v in P.CoeffModulus.create(n, [bits] * k)]
    return ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)


def _u(rng, t, lead, lazy=False, rows=None):
    bounds = [4 * q for q in t.values] if lazy else list(t.values)
    if rows is not None:              # a key's rows: more than the tables'
        bounds = bounds[:-1] + [bounds[-2]] * (rows - len(bounds)) \
            + bounds[-1:]
    return _t(_words(rng, bounds, lead, t.n))


MAC_CASES = {
    # name: (a's shape after J, b's leading axes C, J, lazy)
    "one term (2,5,n)": ((2,), (), 1, True),
    "one term broadcast over 3": ((), (3,), 1, True),
    "key switch (5,6,n) x (5,2,6,n)": ((), (2,), 5, False),
    "hoisted keys over (4, 2)": ((), (4, 2), 5, False),
    "eleven terms in two batches": ((), (2,), 11, False),
    "lazy four terms, row groups": ((3,), (2,), 4, True),
}


@pytest.mark.parametrize("n", [2, 64, 1024])
@pytest.mark.parametrize("case", list(MAC_CASES))
def test_mac_addressing(emulated, case, n):
    lead, comps, J_, lazy = MAC_CASES[case]
    t = _tables(n, 6 if "key" in case else 5)
    rng = np.random.default_rng(SEED + n + len(case))
    a = _u(rng, t, (J_,) + lead, lazy)
    b = _u(rng, t, (J_,) + comps + lead, lazy)
    want = ntt.dyadic_mac_plain(
        a.reshape((J_,) + (1,) * len(comps) + a.shape[1:]), b, t)
    assert torch.equal(ntt.dyadic_mac(a, b, t), want)
    assert [e for e, _ in emulated] == ["troy_dyadic_mac"]


@pytest.mark.parametrize("n", [64, 2048])
def test_mac_reads_key_rows_and_slices_in_place(emulated, n):
    """A switching key's rows below the first level (kb > k: the level's
    primes and the special row), a level slice of the secret key's powers
    (a term pitch past the rows read) and of a public key (a component
    pitch), and a strided addend: read in place, no copy."""
    rng = np.random.default_rng(SEED + n)
    kf, k = 6, 3                                   # key rows, level limbs
    full = _tables(n, kf)
    used = full.select([0, 1, 2, kf - 1])
    key = _u(rng, full, (kf - 1, 2))
    t_hat = _u(rng, used, (k,))
    got = ntt.dyadic_mac(t_hat, key[:k], used)
    want = ntt.dyadic_mac_plain(t_hat.unsqueeze(1),
                                ntt.key_rows_plain(key[:k], used.k), used)
    assert torch.equal(got, want)
    assert torch.equal(want[:, :k], ntt.dyadic_mac_plain(
        t_hat[:, :k].unsqueeze(1), key[:k, :, :k], full.slice(0, k)))
    level = full.slice(0, k)
    powers = _u(rng, full, (2,))                   # (size - 1, kf, n)
    comps = _u(rng, level, (5, 3))
    got = ntt.dyadic_mac(comps[0, 1:], powers[:, :k], level,
                         addend=comps[0, 0])
    assert torch.equal(got, ntt.dyadic_mac_plain(
        comps[0, 1:], powers[:, :k].contiguous(), level, comps[0, 0]))
    got = ntt.dyadic_mac_batched(powers[:, :k].unsqueeze(1), comps[:, 1:],
                                 level, addend=comps[:, :1])
    assert torch.equal(got[:, 0], torch.stack([ntt.dyadic_mac_plain(
        c[1:], powers[:, :k].contiguous(), level, c[0]) for c in comps]))
    pk = _u(rng, full, (2,))                       # (size, kf, n)
    u_ntt = _u(rng, level, (1,))
    got = ntt.dyadic_mac(u_ntt, pk[:, :k].unsqueeze(0), level)
    assert torch.equal(got, ntt.dyadic_mac_plain(
        u_ntt.unsqueeze(1), pk[:, :k].unsqueeze(0).contiguous(), level))
    batched = ntt.dyadic_mac_batched(key[:k], _u(rng, used, (4, k)), used)
    assert batched.shape == (4, 2, used.k, n)
    assert [e for e, _ in emulated] == ["troy_dyadic_mac"] * 5
    # the key, the powers, the addends and the public key went uncopied
    ptr = lambda v: None if v is None else v.data_ptr()
    reads = [(ptr(args[2]), ptr(args[3])) for _, args in emulated]
    assert reads[:4] == [(key.data_ptr(), None),
                         (powers.data_ptr(), comps[0, 0].data_ptr()),
                         (powers.data_ptr(), comps.data_ptr()),
                         (pk.data_ptr(), None)]


@pytest.mark.parametrize("n", [2, 64, 1024])
@pytest.mark.parametrize("s1,s2,batch", [(2, 2, ()), (1, 3, ()), (4, 4, ()),
                                         (3, 2, (2,)), (5, 2, ()),
                                         (6, 6, ()), (2, 3, (2, 2))])
def test_convolve_addressing(emulated, s1, s2, batch, n):
    t = _tables(n, 3)
    rng = np.random.default_rng(SEED + s1 * s2 + n)
    lazy = min(s1, s2) <= 4
    a = _u(rng, t, batch + (s1,), lazy)
    b = _u(rng, t, batch + (s2,), lazy)
    assert torch.equal(ntt.dyadic_convolve(a, b, t),
                       ntt.dyadic_convolve_plain(a, b, t))
    assert [e for e, _ in emulated] == ["troy_dyadic_convolve"]


@pytest.mark.parametrize("n", [64, 1024])
def test_convolve_square_and_strided_batches(emulated, n):
    """The square reads a alone; the sharded runners' views x[:, :2] and
    x[:, 2:] of one (m, 4, R, n) tensor go in place (a batch pitch of 4
    components)."""
    t = _tables(n, 4)
    rng = np.random.default_rng(SEED + n)
    a = _u(rng, t, (3,), True)
    assert torch.equal(ntt.dyadic_convolve(a, a, t),
                       ntt.dyadic_convolve_plain(a, a, t))
    x = _u(rng, t, (3, 4), True)
    got = ntt.dyadic_convolve(x[:, :2], x[:, 2:], t)
    assert torch.equal(got, ntt.dyadic_convolve_plain(x[:, :2], x[:, 2:], t))
    assert [e for e, _ in emulated] == ["troy_dyadic_convolve"] * 2
    # the square hands the kernel a as b; the views go uncopied
    assert emulated[0][1][1] is emulated[0][1][2] and emulated[0][1][3] == 1
    assert emulated[1][1][1].data_ptr() == x.data_ptr()
    assert emulated[1][1][2].data_ptr() == x[:, 2:].data_ptr()


def test_misaligned_operand_is_copied_aligned(emulated):
    """An operand at an odd word offset (off the kernel's 16-byte loads)
    reaches the kernel as an aligned copy: the same words."""
    n = 64
    t = _tables(n, 3)
    rng = np.random.default_rng(SEED)
    a = _u(rng, t, (2,))
    buf = torch.empty(a.numel() + 1, dtype=torch.int64)
    odd = buf[1:].view(a.shape)
    odd.copy_(a)
    assert odd.data_ptr() % 16 == 8
    assert torch.equal(ntt.dyadic_convolve(odd, a, t),
                       ntt.dyadic_convolve_plain(a, a, t))
    assert torch.equal(ntt.dyadic_mac(odd.unsqueeze(0), a.unsqueeze(0), t),
                       ntt.dyadic_mac_plain(a.unsqueeze(0), a.unsqueeze(0),
                                            t))


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def test_wrappers_refuse_what_the_kernel_cannot_take():
    n = 64
    t = _tables(n, 3)
    z = lambda *s: torch.zeros(s, dtype=torch.int64)
    with pytest.raises(ValueError, match="terms"):
        ntt.dyadic_mac(z(2, 3, n), z(3, 3, n), t)
    with pytest.raises(ValueError, match="terms"):
        ntt.dyadic_mac(z(65, 3, n), z(65, 3, n), t)
    with pytest.raises(ValueError, match="broadcast"):
        ntt.dyadic_mac(z(1, 2, 3, n), z(1, 3, 3, n), t)
    with pytest.raises(ValueError, match="broadcast"):
        ntt.dyadic_mac(z(1, 3, n), z(1, 2, n), t)         # fewer rows
    with pytest.raises(ValueError, match="addend"):
        ntt.dyadic_mac(z(1, 3, n), z(1, 2, 3, n), t, addend=z(3, n))
    with pytest.raises(ValueError, match="do not fit"):
        ntt.dyadic_mac_batched(z(2, 2, 3, n), z(4, 3, 3, n), t)
    with pytest.raises(ValueError, match="addend"):
        ntt.dyadic_mac_batched(z(2, 1, 3, n), z(4, 2, 3, n), t,
                               addend=z(4, 3, n))
    with pytest.raises(ValueError, match="do not fit"):
        ntt.dyadic_convolve(z(2, 2, 3, n), z(3, 2, 3, n), t)
    with pytest.raises(ValueError, match="expected"):
        ntt.dyadic_convolve(z(2, 2, n), z(2, 3, n), t)
    with pytest.raises(TypeError, match="int64"):
        ntt.dyadic_convolve(torch.zeros(2, 3, n, dtype=torch.int32),
                            z(2, 3, n), t)

