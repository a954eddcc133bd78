"""Kernel K, the BFV mod switch's divide by the last prime
(troy_tpu_torch/ops/keyswitch.py ``divide_and_round_q_last``,
csrc/keyswitch.cu ``divide_round_kernel``), against troy_tpu, word for word
(tolerance 0), on the CPU.

Levels at n = 64 of 2 to 7 limbs, over 60- and 61-bit primes, with a
20-bit and a 59-bit t (the divide does not read t; the tools differ in it
as users' do); random words from numpy seeds, with the last row at 0,
p - 1 and p/2 +- 1 (where the rounding turns) and data words at 0 and
q - 1:
  * the port's divide against troy_tpu/ops/rns.py:194
    ``divide_and_round_q_last`` on troy_tpu's RnsTool of the same primes
    (61-bit primes are past the contexts' 60-bit limit, so the levels are
    built from the primes; the tool's auxiliary primes at 60 bits), and
    against troy_tpu/evaluator.py:687 ``_bfv_mod_switch_scale`` and
    ``Evaluator.mod_switch_to_next`` of both packages through every level
    of BFV chains over 60-bit primes;
  * F's divide on the same kernel (J's route, the coefficient-sharded key
    switch), ``divide_round_last``, in the accumulator layouts its callers
    use, against the composition of the divide and the accumulator's add;
  * the kernel's launch geometry emulated (csrc/keyswitch.cu's block size
    and limb group read from the source): every output pair of every limb
    written once, the limb groups on the grid's z, a launch for each 65535
    components. The kernel cannot run here; its words are held to the
    plain version on the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import troy_tpu as J
from troy_tpu import evaluator as jev
from troy_tpu.ops import rns as jrns
from troy_tpu.utils import numth
from troy_tpu.utils.rns import make_rns_tool

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch.ops import keyswitch, ntt
from troy_tpu_torch.ops import u64ops as u

torch.set_num_threads(2)

SEED = 2020
N = 64
# (data limbs of the first level, prime bits, t bits)
CONFIGS = [(k, bits, 20 if (k + bits) % 2 else 59)
           for k in range(2, 8) for bits in (60, 61)]
SOURCE = Path(__file__).resolve().parent.parent / "troy_tpu_torch" / "csrc"

_CTX = {}


def _ctxs(k, bits, t_bits):
    """(port context, troy_tpu context): BFV at n = N over k + 1 primes of
    ``bits`` bits (the last the key level's special prime)."""
    key = (k, bits, t_bits)
    if key not in _CTX:
        out = []
        for mod in (P, J):
            parms = mod.EncryptionParameters(
                scheme=mod.SchemeType.bfv, poly_modulus_degree=N,
                coeff_modulus=tuple(mod.CoeffModulus.create(
                    N, [bits] * (k + 1))),
                plain_modulus=mod.PlainModulus.batching(N, t_bits))
            on = {"device": "cpu"} if mod is P else {}
            out.append(mod.HeContext(parms, sec_level=mod.SecurityLevel.none,
                                     **on))
        _CTX[key] = tuple(out)
    return _CTX[key]


def _words(rng, moduli, lead, n=N):
    """Uniform words below each modulus, data words at 0 and q - 1 in the
    first columns and the last row at 0, p - 1 and p/2 +- 1."""
    x = np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                  for q in moduli], axis=-2)
    for j, q in enumerate(moduli[:-1]):
        x[..., j, :2] = [0, q - 1]
    p = moduli[-1]
    x[..., -1, :5] = [0, p - 1, p // 2 - 1, p // 2, p // 2 + 1]
    return x


def _equal(port: torch.Tensor, ref) -> None:
    got, want = interop.to_numpy(port), np.asarray(ref)
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0, "words differ"


@pytest.mark.parametrize("k,bits,t_bits", CONFIGS)
def test_divide_matches_troy_tpu(k, bits, t_bits):
    moduli = numth.get_primes(2 * N, bits, k)
    tool = make_rns_tool(N, tuple(moduli),
                         int(J.PlainModulus.batching(N, t_bits)),
                         internal_prime_bits=60)
    t = ntt.RnsNttTables.from_moduli(N, moduli, "cpu")
    rng = np.random.default_rng(SEED + 10 * k + bits)
    x = _words(rng, moduli, (3,))
    want = np.stack([np.asarray(jrns.divide_and_round_q_last(
        jnp.asarray(x[c]), tool)) for c in range(3)])
    _equal(keyswitch.divide_and_round_q_last(interop.to_torch(x, "cpu"), t),
           want)


@pytest.mark.parametrize("k,t_bits", [(2, 20), (4, 59), (7, 20)])
def test_bfv_mod_switch_scale_matches_troy_tpu(k, t_bits):
    pc, jc = _ctxs(k, 60, t_bits)
    pd, jd = pc.first_context_data, jc.first_context_data
    assert pd.ntt.k == k
    rng = np.random.default_rng(SEED + k)
    x = _words(rng, pd.coeff_values, (2,))
    want = jev._bfv_mod_switch_scale(jnp.asarray(x), jd)
    _equal(keyswitch.divide_and_round_q_last(interop.to_torch(x, "cpu"),
                                             pd.ntt), want)


@pytest.mark.parametrize("k,bits,t_bits", [(7, 60, 20), (4, 60, 59)])
def test_mod_switch_through_the_chain_matches_troy_tpu(k, bits, t_bits):
    """Evaluator.mod_switch_to_next of both packages, level by level down
    to the last, on the same coefficient-form ciphertext words."""
    pc, jc = _ctxs(k, bits, t_bits)
    pev, jevl = P.Evaluator(pc), J.Evaluator(jc)
    rng = np.random.default_rng(SEED + k)
    x = _words(rng, pc.first_context_data.coeff_values, (3,))
    pct = interop.ciphertext(x, pc.first_level, False, "cpu")
    jct = J.Ciphertext(data=jnp.asarray(x), level=jc.first_level,
                       is_ntt_form=False)
    while pct.level < pc.last_level:
        pct, jct = pev.mod_switch_to_next(pct), jevl.mod_switch_to_next(jct)
        assert pct.level == jct.level
        _equal(pct.data, jct.data)


# the accumulator layouts of F's divide: (s, acc shape, group)
LAYOUTS = {"onto (c0, c1)": (2, (2,), None), "onto c0": (2, (1,), None),
           "onto c0 of each pair": (8, (4, 1), 2),
           "one row onto c0 of every pair": (8, (1, 1), 2),
           "none": (3, None, None)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("k", [1, 5, 17])
def test_key_switch_divide_accumulator_layouts(layout, k):
    """divide_round_last in each layout: the plain divide, then the
    accumulator row of component c (group g = c // group, member h) added
    where h < the accumulator's components."""
    n = 256
    moduli = [int(v) for v in P.CoeffModulus.create(n, [50] * (k + 1))]
    t = ntt.RnsNttTables.from_moduli(n, moduli, "cpu", use_mxu=False)
    consts = keyswitch.divide_round_consts(t.slice(0, k), moduli[-1])
    s, acc_lead, group = LAYOUTS[layout]
    rng = np.random.default_rng(SEED + k + len(layout))
    x = interop.to_torch(_words(rng, moduli, (s,), n), "cpu")
    acc = None if acc_lead is None else interop.to_torch(np.stack(
        [rng.integers(0, q, size=acc_lead + (n,), dtype=np.uint64)
         for q in moduli[:k]], axis=-2), "cpu")
    got = keyswitch.divide_round_last(x, consts, acc, group)
    want = keyswitch.divide_round_last_plain(x, consts)
    if acc is not None:
        acc4 = acc.unsqueeze(0) if acc.dim() == 3 else acc
        g = s if group is None else group
        q = t.slice(0, k).q.reshape(-1, 1)
        for c in range(s):
            grp, h = divmod(c, g)
            if h < acc4.shape[1]:
                want[c] = u.add_mod(acc4[grp % acc4.shape[0], h], want[c], q)
    assert torch.equal(got, want)


def test_divide_refuses_what_the_kernel_cannot_take():
    moduli = [int(v) for v in P.CoeffModulus.create(N, [50, 50, 50])]
    t = ntt.RnsNttTables.from_moduli(N, moduli, "cpu")
    with pytest.raises(ValueError, match="expected"):
        keyswitch.divide_and_round_q_last(torch.zeros(2, 2, N,
                                                      dtype=torch.int64), t)
    consts = keyswitch.divide_round_consts(t.slice(0, 2), moduli[-1])
    with pytest.raises(ValueError, match="constants"):
        keyswitch.divide_round_last(torch.zeros(2, 4, N, dtype=torch.int64),
                                    consts)
    with pytest.raises(ValueError, match="accumulator"):
        keyswitch.divide_round_last(torch.zeros(2, 3, N, dtype=torch.int64),
                                    consts, torch.zeros(3, 2, N,
                                                        dtype=torch.int64))


@pytest.mark.parametrize("bgv", [False, True])
def test_unaligned_operand_is_copied_once_for_the_kernel(bgv, monkeypatch):
    """A contiguous operand one word past a 16-byte line: every divide (K's
    and F's, and K''s since it took their 16-byte loads) hands its kernel
    an aligned copy of the same words; an aligned one goes as it is. The
    launch is recorded, not run (no card here)."""
    moduli = [int(v) for v in P.CoeffModulus.create(N, [50, 50, 50])]
    t = ntt.RnsNttTables.from_moduli(N, moduli, "cpu")
    consts = (keyswitch.bgv_divide_consts(t.slice(0, 2), moduli[-1], 65537)
              if bgv else keyswitch.divide_round_consts(t.slice(0, 2),
                                                        moduli[-1]))
    divide = keyswitch.bgv_divide_last if bgv else keyswitch.divide_round_last
    seen = []
    monkeypatch.setattr(keyswitch._kernels, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(keyswitch._kernels, "check_operand",
                        lambda *a, **kw: None)
    monkeypatch.setattr(keyswitch._kernels, "launch",
                        lambda entry, dev, out, x, *rest: seen.append(x))
    buf = torch.arange(2 * 3 * N + 1, dtype=torch.int64)
    view = buf[1:].view(2, 3, N)
    assert view.is_contiguous() and view.data_ptr() & 15 == 8
    aligned = torch.zeros(2, 3, N, dtype=torch.int64)
    divide(view, consts)
    divide(aligned, consts)
    got, same = seen
    assert torch.equal(got, view)
    assert got.data_ptr() != view.data_ptr() and got.data_ptr() & 15 == 0
    assert same is aligned


def _geometry():
    """csrc/keyswitch.cu's block size of the divide (kDivideThreads) and
    the data limbs a thread takes (kDivideGroup)."""
    text = (SOURCE / "keyswitch.cu").read_text()
    threads = re.search(r"constexpr int kDivideThreads = (\d+);", text)
    group = re.search(r"constexpr int kDivideGroup = (\d+);", text)
    return int(threads.group(1)), int(group.group(1))


@pytest.mark.parametrize("comps,k,log_n", [(2, 4, 14), (3, 1, 1),
                                           (1, 17, 12), (70000, 3, 1),
                                           (131071, 2, 2)])
def test_launch_geometry_writes_every_word_once(comps, k, log_n):
    """divide()'s launches: coefficient pairs on x in blocks of the
    source's threads, the component on y (a launch for each 65535, from
    its first component comp0), the limb groups on z; each thread's
    (component, limbs, pair) from its block and thread indices as the
    kernel forms them, every output pair once."""
    threads, gsize = _geometry()
    assert (threads, gsize) == (128, 2)
    pairs = 1 << (log_n - 1)
    gx = (pairs + threads - 1) // threads
    gz = (k + gsize - 1) // gsize
    i = 2 * torch.arange(gx * threads)              # the pair's first word
    i = i[i < (1 << log_n)]
    rows = []
    for comp0 in range(0, comps, 65535):
        gy = min(comps - comp0, 65535)
        by, bz = torch.meshgrid(torch.arange(gy), torch.arange(gz),
                                indexing="ij")
        comp = (comp0 + by).unsqueeze(-1).expand(-1, -1, gsize)
        limb = (bz * gsize).unsqueeze(-1) + torch.arange(gsize)
        keep = limb < k
        rows.append(comp[keep] * k + limb[keep])
    rows = torch.cat(rows).reshape(-1, 1)
    words = (rows * (1 << log_n) + i).flatten()
    assert words.numel() == comps * k * pairs
    assert torch.equal(torch.sort(words).values,
                       torch.arange(0, (comps * k) << log_n, 2))
