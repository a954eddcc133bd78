"""Kernel O3, the CKKS centred CRT composition (troy_tpu_torch/csrc/
embedding.cu ``compose_kernel``), emulated step by step on the CPU and held
bit for bit to its plain version and to troy_tpu's
``compose_centered_device`` (tolerance 0: the same f64 bits).

The kernel does not reduce mod Q by the JAX package's k - 1 conditional
subtracts. It sums every limb's x_j = r_j invp_j mod q_j, both as W words
of x_j P_j and, in limb order, as the f64 sum of x_j / q_j. It then
subtracts e Q once, e the integer nearest the f64 sum S, and only where S
lies within the tie margin of a half-integer compares |v| with (Q + 1)/2.
The emulation runs those steps in the kernel's order at k = 1, 2, 5 and
16 limbs (W = 2 to 16 words). The inputs are random residues from
numpy seeds and the adversarial CRT values: 0, +-1, small +- values,
+-(Q-1)/2, (Q+-1)/2, Q-1, and values whose S lies within 2^-40 of a
half-integer. The tie margin is read from the CUDA source, so a change
there is checked here before the card.
"""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from troy_tpu.ops import embedding as jemb

import troy_tpu_torch as P
from troy_tpu_torch import interop
from troy_tpu_torch.ops import embedding as emb
from troy_tpu_torch.ops import ntt
from troy_tpu_torch.ops import u64ops as u

torch.set_num_threads(1)

SEED = 1717
N = 1024
# k limbs of these widths: W = words(Q) + 1 from 2 to 16
LEVELS = {1: [60], 2: [60, 40], 5: [60, 40, 40, 40, 40], 16: [60] * 16}


def _tie_margin() -> float:
    """kComposeTieMargin as csrc/embedding.cu sets it."""
    src = (Path(emb.__file__).resolve().parents[1] / "csrc"
           / "embedding.cu").read_text()
    return float.fromhex(re.search(
        r"constexpr double kComposeTieMargin = ([0-9a-fx.p+-]+);",
        src).group(1))


def _tables(k):
    q = tuple(int(m) for m in P.CoeffModulus.create(N, LEVELS[k]))
    return q, emb.make_rns_round_tables(
        ntt.RnsNttTables.from_moduli(N, q, "cpu"))


def _residues(rng, q, values):
    """(k, N) residues: the CRT values `values` (ints, any sign) first,
    random residues after them."""
    res = np.stack([rng.integers(0, qi, N, dtype=np.uint64) for qi in q])
    for i, v in enumerate(values):
        res[:, i] = [v % qi for qi in q]
    return res


def _adversarial(Q, rng):
    """The CRT values around 0 and Q/2, and ones whose S lies within 2^-40
    of a half-integer (frac(S) = (v mod Q) / Q)."""
    h = (Q - 1) // 2
    near = [h - int(rng.integers(0, 1 << 30)) * (Q >> 72)
            for _ in range(6)]
    near += [h + 1 + int(rng.integers(0, 1 << 30)) * (Q >> 72)
             for _ in range(6)]
    return ([0, 1, -1, 2, -2, 12345, -12345, 1 << 40, -(1 << 40), h, -h,
             h + 1, Q - 1, (Q + 1) // 2, Q - 2] + near, near)


def _words(v, count):
    return [u.s64((v >> (64 * i)) & u.M64) for i in range(count)]


def _emulated_compose(residues, rt, inv_scale):
    """The kernel's steps: (the f64 output, S, the accumulator's words,
    where the tie correction changed the value)."""
    q_values = rt.q_values
    k, W = len(q_values), rt.words
    c = rt.compose_consts
    q, invp, invp_shoup = (c[i * k:(i + 1) * k].reshape(k, 1)
                           for i in range(3))
    inv_q = c[3 * k + k * W + 2 * W:].view(torch.float64)
    assert inv_q.shape == (k,)
    x = u.mul_mod_shoup(residues, invp, invp_shoup, q)
    zero = torch.zeros_like(residues[0])
    ult = lambda a, b: u.ult(a, b).to(torch.int64)
    s = torch.zeros(residues.shape[1], dtype=torch.float64)
    acc = [zero] * W
    for j in range(k):
        s = s + x[j].to(torch.float64) * inv_q[j]
        carry = zero
        nxt = []
        for w, pw in enumerate(_words(rt.punct[j], W)):
            lo, hi = u.mul128(x[j], pw)
            s1 = acc[w] + lo
            c1 = ult(s1, lo)
            s2 = s1 + carry
            c2 = ult(s2, carry)
            nxt.append(s2)
            carry = hi + c1 + c2
        acc = nxt
    # v = acc - e Q, e the integer nearest S (ties to even, as rint)
    e_f = torch.round(s)
    e = e_f.to(torch.int64)
    carry, borrow = zero, zero
    v = []
    for w, qw in enumerate(_words(rt.total, W)):
        lo, hi = u.mul128(e, qw)
        m = lo + carry
        carry = hi + ult(m, lo)
        d = acc[w] - m
        b1 = ult(acc[w], m)
        v.append(d - borrow)
        borrow = b1 + ult(d, borrow)
    neg = v[W - 1] < 0
    c1 = torch.ones_like(zero)
    mag = []
    for w in range(W):         # |v|: ~v + 1 where v < 0
        nw = ~v[w] + c1
        c1 = c1 * (nw == 0).to(torch.int64)
        mag.append(torch.where(neg, nw, v[w]))
    near = (s - e_f).abs() > 0.5 - _tie_margin()
    b = zero
    for w, hw in enumerate(_words((rt.total + 1) // 2, W)):
        b = ult(mag[w], hw) + ult(mag[w] - hw, b)
    fix = near & (b == 0)
    b = zero
    flipped = []
    for w, qw in enumerate(_words(rt.total, W)):
        d1 = qw - mag[w]
        b1 = ult(qw, mag[w])
        flipped.append(d1 - b)
        b = b1 + ult(d1, b)
    mag = [torch.where(fix, f, m) for f, m in zip(flipped, mag)]
    neg = neg ^ fix
    f = torch.zeros(residues.shape[1], dtype=torch.float64)
    for w in reversed(range(W)):
        hi = u.shr(mag[w], 32).to(torch.float64)
        lo = (mag[w] & 0xFFFFFFFF).to(torch.float64)
        f = f * (2.0 ** 64) + hi * (2.0 ** 32) + lo
    return torch.where(neg, -f, f) * inv_scale, s, acc, fix


def test_tie_margin_covers_the_f64_error():
    """S's f64 error at 64 limbs (a rounding in each conversion, product
    and sum) stays far inside the margin, and the margin is far from 1/2."""
    margin = _tie_margin()
    assert 64 * 67 * 2.0 ** -53 < margin / 2 ** 8
    assert margin < 2.0 ** -20


@pytest.mark.parametrize("k", sorted(LEVELS))
def test_emulated_kernel_is_the_plain_version_and_troy_tpu(k):
    q, rt = _tables(k)
    Q = rt.total
    assert rt.words == (Q.bit_length() + 63) // 64 + 1
    rng = np.random.default_rng(SEED + k)
    values, near = _adversarial(Q, rng)
    for v in near:                       # placed within 2^-40 of a half
        assert abs(Fraction(v % Q, Q) - Fraction(1, 2)) < Fraction(1, 2 ** 40)
    res = _residues(rng, q, values)
    t = interop.to_torch(res, "cpu")
    want = np.asarray(jemb.compose_centered_device(
        res, jemb.make_rns_round_tables(q)))
    for inv_scale in (1.0, 2.0 ** -40, 1.0 / 3.0):
        plain = emb.compose_centered_plain(t, rt, inv_scale)
        np.testing.assert_array_equal(plain.numpy(), want * inv_scale)
        got, s, acc, _ = _emulated_compose(t, rt, inv_scale)
        assert torch.equal(got, plain), (k, inv_scale)
    # the exact sums behind it: acc = S Q, with S within the margin's
    # reach of the f64 sum
    got, s, acc, fix = _emulated_compose(t, rt, 1.0)
    for i in range(len(values)):
        exact = sum((int(a) & u.M64) << (64 * w) for w, a in
                    enumerate(x[i] for x in acc))
        assert abs(Fraction(exact, Q) - Fraction(float(s[i]))) \
            < Fraction(_tie_margin()) / 2 ** 8
    # the values exact in f64: their own value, centred
    for i, v in enumerate(values):
        centred = v % Q - Q if v % Q > Q // 2 else v % Q
        if abs(centred) < 2 ** 53:
            assert float(got[i]) == float(centred), v


def test_tie_correction_runs_and_is_needed():
    """At the values next to Q/2 the rounded multiple is one off often
    enough that the correction changes words; without it the results
    would leave the centred range."""
    fixes = 0
    for k in sorted(LEVELS):
        q, rt = _tables(k)
        rng = np.random.default_rng(SEED + 100 + k)
        values, near = _adversarial(rt.total, rng)
        res = interop.to_torch(_residues(rng, q, near), "cpu")
        _, _, _, fix = _emulated_compose(res, rt, 1.0)
        fixes += int(fix[:len(near)].sum())
        assert int(fix[len(near):].sum()) == 0      # random values: never
    assert fixes > 0


def test_wrapper_refuses_what_the_kernel_cannot_take():
    q, rt = _tables(2)
    with pytest.raises(ValueError, match="expected"):
        emb.compose_centered(torch.zeros((3, N), dtype=torch.int64), rt)
