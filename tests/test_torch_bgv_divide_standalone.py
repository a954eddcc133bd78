"""Kernel K'', the BGV divide by the prime of the last row in the
coefficient domain (troy_tpu_torch/ops/keyswitch.py ``bgv_divide_last``,
csrc/keyswitch.cu ``bgv_divide_kernel``, since it took K's design: K's
``divide_body``), against troy_tpu, word for word (tolerance 0), on the
CPU.

Levels at n = 64 of 2 to 7 limbs over 60- and 61-bit primes, with a 20-bit
and a 59-bit t (t sets the multiple subtracted); random words from numpy
seeds, with the last row at 0, 1, p - 1 and p/2 +- 1 and data words at 0
and q - 1:
  * the port's divide against troy_tpu/ops/rns.py:281
    ``mod_t_and_divide_q_last`` on troy_tpu's RnsTool of the same primes,
    component by component, in every accumulator layout of the port's
    callers (the BGV mod switch: none; the coefficient-form key switch's
    divide by P: onto (c0, c1), onto c0, onto c0 of each pair, one row onto
    c0 of every pair), each accumulator row added to troy_tpu's words;
  * the port's ``mod_t_and_divide_q_last`` at every level of a BGV chain
    against troy_tpu's divide on the level's RnsTool;
  * the kernel's per-thread work emulated: each thread's two coefficients
    and group of limbs (the source's kBgvDivideGroup) from its block and
    thread indices, its
    constants read at the offsets of csrc/divide_round.cuh
    ``DivideLayout``, neg_k formed from the special row by every group;
  * the wrapper on an operand at an odd word offset: the kernel is handed
    an aligned copy of the same words (its 16-byte loads).
The kernel cannot run here; its words are held to the plain version on
the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu.ops import rns as jrns
from troy_tpu.utils import numth
from troy_tpu.utils.rns import make_rns_tool

import troy_tpu_torch as P
from troy_tpu_torch import _kernels, interop
from troy_tpu_torch.ops import keyswitch, ntt
from troy_tpu_torch.ops import rns as prns
from troy_tpu_torch.ops import u64ops as u

torch.set_num_threads(2)

SEED = 2121
N = 64
CONFIGS = [(k, bits, 20 if (k + bits) % 2 else 59)
           for k in range(2, 8) for bits in (60, 61)]
# the accumulator layouts of K''s callers: (s, acc shape, group)
LAYOUTS = {"none (the mod switch)": (3, None, None),
           "onto (c0, c1)": (2, (2,), None), "onto c0": (2, (1,), None),
           "onto c0 of each pair": (8, (4, 1), 2),
           "one row onto c0 of every pair": (8, (1, 1), 2)}
SOURCE = (Path(__file__).resolve().parent.parent / "troy_tpu_torch" / "csrc"
          / "keyswitch.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


# csrc/keyswitch.cu's block size and K'''s limbs a thread
THREADS, GROUP = _constant("kDivideThreads"), _constant("kBgvDivideGroup")


def _words(rng, moduli, lead, n=N):
    """Uniform words below each modulus, data words at 0 and q - 1 and the
    last row at 0, 1, p - 1 and p/2 +- 1."""
    x = np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                  for q in moduli], axis=-2)
    for j, q in enumerate(moduli[:-1]):
        x[..., j, :2] = [0, q - 1]
    p = moduli[-1]
    x[..., -1, 2:8] = [0, 1, p - 1, p // 2 - 1, p // 2, p // 2 + 1]
    return x


def _acc(rng, moduli, lead):
    if lead is None:
        return None
    return interop.to_torch(np.stack(
        [rng.integers(0, q, size=lead + (N,), dtype=np.uint64)
         for q in moduli], axis=-2), "cpu")


def _with_acc(want: torch.Tensor, acc, group, q) -> torch.Tensor:
    """want (s, k, n) with the accumulator row of component c (group g = c
    // group, member h) added where h < the accumulator's components."""
    if acc is None:
        return want
    acc4 = acc.unsqueeze(0) if acc.dim() == 3 else acc
    g = want.shape[0] if group is None else group
    out = want.clone()
    for c in range(want.shape[0]):
        grp, h = divmod(c, g)
        if h < acc4.shape[1]:
            out[c] = u.add_mod(acc4[grp % acc4.shape[0], h], want[c], q)
    return out


def _level(k, bits, t_bits):
    moduli = numth.get_primes(2 * N, bits, k)
    tt = int(J.PlainModulus.batching(N, t_bits))
    tool = make_rns_tool(N, tuple(moduli), tt, internal_prime_bits=60)
    t = ntt.RnsNttTables.from_moduli(N, moduli, "cpu")
    consts = keyswitch.bgv_divide_consts(t.slice(0, k - 1), moduli[-1], tt)
    return moduli, tool, t, consts


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("k,bits,t_bits", CONFIGS)
def test_bgv_divide_matches_troy_tpu(k, bits, t_bits, layout):
    moduli, tool, t, consts = _level(k, bits, t_bits)
    s, acc_lead, group = LAYOUTS[layout]
    rng = np.random.default_rng(SEED + 10 * k + bits + len(layout))
    x = _words(rng, moduli, (s,))
    acc = _acc(rng, moduli[:-1], acc_lead)
    want = torch.stack([interop.to_torch(np.asarray(
        jrns.mod_t_and_divide_q_last(jnp.asarray(x[c]), tool)), "cpu")
        for c in range(s)])
    want = _with_acc(want, acc, group, t.slice(0, k - 1).q.reshape(-1, 1))
    got = keyswitch.bgv_divide_last(interop.to_torch(x, "cpu"), consts, acc,
                                    group)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,t_bits", [(2, 20), (5, 59), (7, 20)])
def test_bgv_mod_switch_divide_matches_troy_tpu(k, t_bits):
    """The port's ``mod_t_and_divide_q_last`` (the BGV mod switch's divide
    in the coefficient domain, one K'' launch on a card) at every level of
    a BGV chain over 60-bit primes against troy_tpu's on the level's
    RnsTool."""
    parms = {}
    for mod in (P, J):
        parms[mod] = mod.EncryptionParameters(
            scheme=mod.SchemeType.bgv, poly_modulus_degree=N,
            coeff_modulus=tuple(mod.CoeffModulus.create(N, [60] * (k + 1))),
            plain_modulus=mod.PlainModulus.batching(N, t_bits))
    pc = P.HeContext(parms[P], sec_level=P.SecurityLevel.none, device="cpu")
    jc = J.HeContext(parms[J], sec_level=J.SecurityLevel.none)
    rng = np.random.default_rng(SEED + k)
    for level in range(pc.first_level, pc.last_level):
        pd, jd = pc.get_context_data(level), jc.get_context_data(level)
        x = _words(rng, pd.coeff_values, (2,))
        want = np.stack([np.asarray(jrns.mod_t_and_divide_q_last(
            jnp.asarray(x[c]), jd.rns_tool)) for c in range(2)])
        kq = pd.ntt.k
        consts = keyswitch.bgv_divide_consts(
            pd.ntt.slice(0, kq - 1), pd.coeff_values[-1],
            int(pd.plain_modulus))
        got = prns.mod_t_and_divide_q_last(interop.to_torch(x, "cpu"),
                                           pd.ntt, consts)
        np.testing.assert_array_equal(interop.to_numpy(got), want)


def _emulate(x: torch.Tensor, consts: torch.Tensor, acc, group):
    """csrc/keyswitch.cu divide_body<true> thread by thread: block
    (coefficient pairs x, component y, limb group z), two coefficients a
    thread, its constants read at DivideLayout's offsets (q 0, ratio k,
    inv 3k, inv_shoup 4k, tt 5k + 2, tt_hi 5k + 3, inv_t 5k + 4,
    inv_t_shoup 5k + 5, pm 5k + 6, pm_shoup 6k + 6), neg_k formed from
    row k in every group, the accumulator row of the component added."""
    s, k, n = x.shape[0], x.shape[1] - 1, x.shape[2]
    acc4 = None if acc is None else (acc.unsqueeze(0) if acc.dim() == 3
                                     else acc)
    group = s if group is None else group
    c = [int(v) & u.M64 for v in consts.tolist()]
    w = lambda off: u.s64(c[off])
    out = torch.full((s, k, n), -1, dtype=torch.int64)
    grid_x = (n // 2 + THREADS - 1) // THREADS
    i = 2 * torch.arange(grid_x * THREADS)
    i = i[i < n]                                       # the live threads
    for comp in range(s):
        g, h = divmod(comp, group)
        arow = (g % acc4.shape[0]) * acc4.shape[1] + h \
            if acc4 is not None and h < acc4.shape[1] else -1
        for z in range((k + GROUP - 1) // GROUP):
            xk = x[comp, k]
            neg = u.mul_mod_shoup(u.neg_mod(u.barrett_reduce_64(
                xk, w(5 * k + 2), w(5 * k + 3)), w(5 * k + 2)),
                w(5 * k + 4), w(5 * k + 5), w(5 * k + 2))
            for j in range(z * GROUP, min(k, z * GROUP + GROUP)):
                q, ratio = w(j), w(k + j)
                for pair in (i, i + 1):
                    delta = u.mul_mod_shoup(
                        u.barrett_reduce_64(neg[pair], q, ratio),
                        w(5 * k + 6 + j), w(6 * k + 6 + j), q)
                    lazy = x[comp, j, pair] + (
                        2 * q - u.barrett_reduce_64(xk[pair], q, ratio)
                        - delta)
                    r = u.mul_mod_shoup(lazy, w(3 * k + j), w(4 * k + j), q)
                    if arow >= 0:
                        r = u.add_mod(acc4.reshape(-1, k, n)[arow, j, pair],
                                      r, q)
                    assert bool((out[comp, j, pair] == -1).all())
                    out[comp, j, pair] = r
    assert bool((out >= 0).all())
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("k", [2, 5, 8])
def test_kernel_threads_emulated(k, layout):
    """The emulated threads write every output word once, with the plain
    version's words."""
    moduli, _, _, consts = _level(k, 60, 20 if k % 2 else 59)
    s, acc_lead, group = LAYOUTS[layout]
    rng = np.random.default_rng(SEED + k + len(layout))
    x = interop.to_torch(_words(rng, moduli, (s,)), "cpu")
    acc = _acc(rng, moduli[:-1], acc_lead)
    assert torch.equal(_emulate(x, consts, acc, group),
                       keyswitch.bgv_divide_last_plain(x, consts, acc, group))


@pytest.mark.parametrize("with_acc", [False, True])
def test_unaligned_operand_reaches_the_kernel_aligned(with_acc, monkeypatch):
    """An operand one word past a 16-byte line (and an accumulator so
    placed): the wrapper hands K''s kernel an aligned copy of the same
    words, and an aligned operand as it is. The launch is recorded, not
    run (no card here)."""
    moduli, _, t, consts = _level(4, 60, 20)
    rng = np.random.default_rng(SEED)
    x = interop.to_torch(_words(rng, moduli, (2,)), "cpu")
    acc = _acc(rng, moduli[:-1], (2,)) if with_acc else None
    seen = []
    monkeypatch.setattr(_kernels, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(_kernels, "check_operand", lambda *a, **kw: None)
    monkeypatch.setattr(_kernels, "launch",
                        lambda entry, dev, out, xx, aa, *rest:
                        seen.append((entry, xx, aa)))

    def odd(v):
        buf = torch.empty(v.numel() + 1, dtype=v.dtype)
        view = buf[1:].view(v.shape)
        view.copy_(v)
        assert view.is_contiguous() and view.data_ptr() & 15 == 8
        return view

    keyswitch.bgv_divide_last(odd(x), consts, odd(acc) if with_acc else None)
    keyswitch.bgv_divide_last(x, consts, acc)
    (entry, x1, a1), (_, x2, a2) = seen
    assert entry == "troy_bgv_divide_coeff"
    assert torch.equal(x1, x) and x1.data_ptr() & 15 == 0
    assert x2 is x
    if with_acc:
        assert torch.equal(a1.reshape(acc.shape), acc)
        assert a1.data_ptr() & 15 == 0
        assert a2.data_ptr() == acc.data_ptr()


def test_bgv_divide_refusals():
    moduli, _, t, consts = _level(3, 60, 20)
    with pytest.raises(ValueError, match="constants"):
        keyswitch.bgv_divide_last(torch.zeros(2, 4, N, dtype=torch.int64),
                                  consts)
    with pytest.raises(ValueError, match="accumulator"):
        keyswitch.bgv_divide_last(torch.zeros(2, 3, N, dtype=torch.int64),
                                  consts, torch.zeros(3, 2, N,
                                                      dtype=torch.int64))
    with pytest.raises(ValueError, match="expected"):
        keyswitch.bgv_divide_last(torch.zeros(2, N, dtype=torch.int64),
                                  consts)
