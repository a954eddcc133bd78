"""The negacyclic NTT as two exact int8 matrix products (kernel J).

The port of troy_tpu/ops/ntt_mxu.py. The size-n transform factors as
n = A x B:

    out = ((W1 @ C) * Tw) @ W2          (all mod q)

with C the coefficients as an (A, B) array, W1 (A, A) and W2 (B, B) the
factor matrices that absorb the negacyclic twist, the bit-reversed output
order and (inverse) 1/n, and Tw an (A, B) twiddle grid. The inverse is
C = V1 @ ((OUT @ V2) * iTw). Each product is exact in int8 arithmetic
through biased byte planes: x = sum_i 2^(8i) (d_i + 128) with d_i in
[-128, 127], so a value below 2^(8D) is D planes, and

    W @ X = T @ S + 128 rowsum(T) + 128 colsum(S) + 128^2 K

per plane pair (T, S the biased planes, K the contraction length). The
plane products of one digit sum s = i + j add up in an int32 accumulator,
the bias terms fold in, the sums regroup in radix 2^32 with a static
offset that makes them nonnegative, and a Shoup fold by 2^(32g) mod q
brings each group back to [0, q).

Kernel J (csrc/ntt_mxu.cu) computes each stage's product as the short
transform the factor matrix is, with butterflies in shared memory: W1 is
the negacyclic A-point NTT with root psi^B (bit-reversed output), W2 the
cyclic B-point NTT with root omega^A, whose butterfly network is the
negacyclic one with round r's twiddles 2^r + i read from entry i of the
length-B table of psi^A (``b_roots`` holds them so); V1 and V2 are their
inverses, V2's 1/B folded into the inverse grid (``itw_b``). The words
are exact residues, so they equal the matrix products'. Its plain version
here runs the matrix algebra with the plane products as float64
``torch.matmul`` (exact: each plane-pair sum is at most 2^14 K <= 2^23 in
magnitude, far below 2^53), which also runs on CUDA tensors for the
card's comparisons. A wrapper runs the plain version for tensors on the
CPU and launches the kernel for tensors on CUDA.

The tables of one (n, q) are made once per device (``make_mxu_tables``,
cached) through the native runtime's ``mxu_tables_fill`` when it loads,
else in Python integers (``make_mxu_tables_host``); both give
troy_tpu's words.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from . import u64ops as u
from .. import _kernels, native
from ..interop import to_torch
from ..utils import numth

DIGITS = 8            # byte planes of the widest residue (61-bit moduli)
# The smallest ring J takes: both factors at least 32 (the kernel's
# shortest line), a row at least one 2048-word tile.
MXU_MIN_N = 2048
# The largest factor: the plain version's int32 bound (|acc| <= min(D, Dx)
# 4 128^2 K < 2^31, as troy_tpu's) and the kernel's longest line.
MAX_FACTOR = 512


def _ndigits(q: int) -> int:
    """Biased byte planes of residues in [0, q): ceil(bitlen(q - 1) / 8)
    (5 for 40-bit primes, 8 for 60-bit)."""
    return _ndigits_value(q - 1)


def _ndigits_value(v: int) -> int:
    """Byte planes covering values in [0, v]."""
    return max(1, (int(v).bit_length() + 7) // 8)


def _split_factors(n: int) -> Tuple[int, int]:
    """n = A * B with A, B as close to square as possible (A >= B)."""
    log_n = n.bit_length() - 1
    a = 1 << ((log_n + 1) // 2)
    return a, n // a


def _biased_digits_host(mat: np.ndarray, ndig: int) -> np.ndarray:
    """u64 matrix -> (ndig, ...) int8 biased byte planes: plane i holds
    byte_i(x) - 128, so x = sum_i 2^(8i) (plane_i + 128). Exact for
    x < 2^(8 ndig) (asserted)."""
    m = np.asarray(mat, dtype=np.uint64)
    if 8 * ndig < 64:
        assert not (m >> np.uint64(8 * ndig)).any(), \
            "value exceeds the byte-plane range"
    planes = np.stack(
        [((m >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.int16)
         for i in range(ndig)])
    return (planes - np.int16(128)).astype(np.int8)


def _plane_sums(planes: np.ndarray, axis: int) -> np.ndarray:
    """Per-plane sums of the biased digits over the contraction axis, the
    host half of the bias correction (int32)."""
    return planes.astype(np.int32).sum(axis=axis, dtype=np.int32)


def _signed_digits_host(mat: np.ndarray, ndig: int = DIGITS) -> np.ndarray:
    """u64 matrix -> (ndig, ...) int8 signed radix-256 planes (exact): the
    Python version of the native runtime's ``signed_digits_fill``."""
    out = np.zeros((ndig,) + mat.shape, dtype=np.int64)
    rem = mat.astype(object)
    carry = np.zeros(mat.shape, dtype=object)
    for i in range(ndig):
        d = (rem & 0xFF) + carry
        carry = np.where(d >= 128, 1, 0)
        d = np.where(d >= 128, d - 256, d)
        out[i] = d.astype(np.int64)
        rem = rem >> 8
    assert (rem + carry == 0).all(), "value exceeded the digit range"
    return out.astype(np.int8)


def _m_off(q: int, d: int, dx: int, k: int) -> int:
    """The static offset of the radix-2^32 regroup: a multiple of q above
    the largest |group accumulator| of D x Dx plane pairs at contraction
    K (troy_tpu/ops/ntt_mxu.py:353-360)."""
    max_sum = min(d, dx) * 4 * 128 * 128 * k
    assert max_sum < (1 << 31), "per-digit-sum accumulator exceeds int32"
    max_acc = max_sum * ((1 << 24) + (1 << 16) + (1 << 8) + 1)
    m_off = (max_acc // q + 1) * q
    assert m_off + max_acc < (1 << 63), "group accumulator exceeds int64"
    return m_off


@dataclass(eq=False)
class MxuNttTables:
    """The factor matrices of one (n, q) on one device: biased byte planes
    of W1, W2, V1, V2 with their plane sums over the contraction axis, the
    twiddle grids with their Shoup words and W2 and V2 transposed (the
    plain version's and troy_tpu's); the butterfly tables kernel J reads
    (``a_roots``: psi^B's powers at bit-reversed positions, the A-point
    table of kernel A's layout; ``b_roots``: the cyclic B-point table,
    entry 2^r + i = (psi^A)^brv(i); their inverses and Shoup words; the
    inverse grid over B, ``itw_b``), and the per-modulus constants
    (``consts``)."""

    w1_digits: torch.Tensor      # (D, A, A) int8
    w1_sums: torch.Tensor        # (D, A) int32
    w2_digits: torch.Tensor      # (D, B, B) int8
    w2_sums: torch.Tensor        # (D, B) int32
    tw: torch.Tensor             # (A, B) u64 words
    tw_shoup: torch.Tensor       # (A, B)
    iw1_digits: torch.Tensor     # (D, A, A) int8  (V1)
    iw1_sums: torch.Tensor       # (D, A) int32
    iw2_digits: torch.Tensor     # (D, B, B) int8  (V2)
    iw2_sums: torch.Tensor       # (D, B) int32
    itw: torch.Tensor            # (A, B)
    itw_shoup: torch.Tensor      # (A, B)
    w2t_digits: torch.Tensor     # (D, B, B) int8, W2 transposed
    iw2t_digits: torch.Tensor    # (D, B, B) int8, V2 transposed
    # [q, Barrett ratio high word, D, m_off at K = A, m_off at K = B,
    #  2^(32 g) mod q for g < 4, their Shoup words, 1/A mod q, its Shoup
    #  word, 1 unused]
    consts: torch.Tensor         # (16,) u64 words
    a_roots: torch.Tensor        # (A,) the A-point table, Shoup words,
    a_roots_shoup: torch.Tensor  #   inverse roots and theirs
    a_inv_roots: torch.Tensor
    a_inv_roots_shoup: torch.Tensor
    b_roots: torch.Tensor        # (B,) the cyclic B-point table, and so on
    b_roots_shoup: torch.Tensor
    b_inv_roots: torch.Tensor
    b_inv_roots_shoup: torch.Tensor
    itw_b: torch.Tensor          # (A, B) iTw / B
    itw_b_shoup: torch.Tensor
    n: int
    a: int
    b: int
    modulus: int

    @property
    def planes(self) -> int:
        return self.w1_digits.shape[0]

    def pointers(self) -> list:
        """The device addresses the kernel reads for this modulus, in the
        order of csrc/ntt_mxu.cu's pointer table."""
        return [t.data_ptr() for t in (
            self.a_roots, self.a_roots_shoup, self.a_inv_roots,
            self.a_inv_roots_shoup, self.b_roots, self.b_roots_shoup,
            self.b_inv_roots, self.b_inv_roots_shoup, self.tw, self.tw_shoup,
            self.itw_b, self.itw_b_shoup, self.consts)] + [0, 0, 0]


@lru_cache(maxsize=None)
def make_mxu_tables_host(n: int, q: int):
    """The 4-step factor matrices in Python integers (numpy object
    arrays): (A, B, w1, tw, w2, v1, itw, v2) as
    troy_tpu/ops/ntt_mxu.py:135 makes them."""
    A, B = _split_factors(n)
    log_a, log_b = A.bit_length() - 1, B.bit_length() - 1
    psi = numth.minimal_primitive_root(2 * n, q)     # 2n-th root
    omega = pow(psi, 2, q)                           # n-th root
    inv_psi = numth.invert_mod(psi, q)
    inv_omega = numth.invert_mod(omega, q)
    inv_a = numth.invert_mod(A, q)
    inv_b = numth.invert_mod(B, q)

    brv_a = [numth.reverse_bits(i, log_a) for i in range(A)]
    brv_b = [numth.reverse_bits(i, log_b) for i in range(B)]

    def pow_table(base: int, count: int):
        t = [1] * count
        for i in range(1, count):
            t[i] = t[i - 1] * base % q
        return t

    om = pow_table(omega, n)          # omega^j, j mod n
    iom = pow_table(inv_omega, n)
    ps = pow_table(psi, 2 * n)        # psi^j, j mod 2n
    ips = pow_table(inv_psi, 2 * n)

    # forward: out[p1, p2] = sum_b [sum_a c[a,b] W1[p1,a]] Tw[p1,b] W2[b,p2]
    w1 = np.array([[om[B * a * r % n] * ps[a * B % (2 * n)] % q
                    for a in range(A)] for r in brv_a], dtype=object)
    tw = np.array([[ps[b] * om[b * r % n] % q
                    for b in range(B)] for r in brv_a], dtype=object)
    w2 = np.array([[om[A * b * r % n] for r in brv_b]
                   for b in range(B)], dtype=object)
    # inverse: Y = (OUT @ V2) / Tw ; C = V1 @ Y
    v2 = np.array([[inv_b * iom[A * b * r % n] % q
                    for b in range(B)] for r in brv_b], dtype=object)
    itw = np.array([[ips[b] * iom[b * r % n] % q
                     for b in range(B)] for r in brv_a], dtype=object)
    v1 = np.array([[inv_a * iom[B * a * r % n] % q * ips[a * B % (2 * n)] % q
                    for r in brv_a] for a in range(A)], dtype=object)
    return A, B, w1, tw, w2, v1, itw, v2


def _host_matrices(n: int, q: int):
    """(A, B, w1, tw, w2, v1, itw, v2, tw_shoup, itw_shoup) as u64 numpy
    arrays: the native runtime's fill when it loads, else Python
    integers."""
    A, B = _split_factors(n)
    psi = numth.minimal_primitive_root(2 * n, q)
    filled = native.mxu_tables_fill(n, A, B, q, psi)
    if filled is not None:
        w1, tw, w2, v1, itw, v2, tws, itws = filled
        return A, B, w1, tw, w2, v1, itw, v2, tws, itws
    A, B, w1, tw, w2, v1, itw, v2 = make_mxu_tables_host(n, q)
    as_u64 = lambda m: np.array([[int(x) & u.M64 for x in row] for row in m],
                                dtype=np.uint64)
    shoup = lambda m: as_u64([[u.shoup_quotient(int(x), q) for x in row]
                              for row in m])
    return (A, B, as_u64(w1), as_u64(tw), as_u64(w2), as_u64(v1),
            as_u64(itw), as_u64(v2), shoup(tw), shoup(itw))


def butterfly_tables_host(n: int, q: int):
    """Kernel J's butterfly tables of (n, q) in Python integers: (a_roots,
    a_inv_roots, b_roots, b_inv_roots) as lists. a_roots[j] =
    (psi^B)^brv(j) (log2 A bits): the A-point negacyclic table of
    ops/ntt.py's layout, W1's transform. b_roots[2^r + i] =
    (psi^A)^brv(i) (log2 B bits), entry 0 = 1: the cyclic B-point table,
    W2's transform. The inverses are elementwise."""
    A, B = _split_factors(n)
    psi = numth.minimal_primitive_root(2 * n, q)
    root_a, root_b = pow(psi, B, q), pow(psi, A, q)

    def negacyclic(root, length):
        bits = length.bit_length() - 1
        return [pow(root, numth.reverse_bits(j, bits), q)
                for j in range(length)]

    neg_b = negacyclic(root_b, B)
    cyclic = [1] + [neg_b[j - (1 << (j.bit_length() - 1))]
                    for j in range(1, B)]
    a_roots = negacyclic(root_a, A)
    inverse = lambda t: [numth.invert_mod(x, q) for x in t]
    return a_roots, inverse(a_roots), cyclic, inverse(cyclic)


@lru_cache(maxsize=None)
def _make_mxu_tables(n: int, q: int, device: str) -> MxuNttTables:
    A, B, w1, tw, w2, v1, itw, v2, tws, itws = _host_matrices(n, q)
    nd = _ndigits(q)
    dev = torch.device(device)

    def planes_and_sums(m, axis):
        """Biased planes and their sums over the contraction axis (W1 and
        V1 multiply from the left and contract their columns, axis 1; W2
        and V2 from the right and contract their rows, axis 0)."""
        pl = _biased_digits_host(m, nd)
        return (torch.from_numpy(pl).to(dev),
                torch.from_numpy(_plane_sums(pl, 1 + axis)).to(dev))

    def with_shoup(values):
        """A table of words < q and its Shoup words, on the device."""
        return (u.u64(values, dev),
                u.u64([u.shoup_quotient(int(v), q) for v in values], dev))

    w1_d, w1_s = planes_and_sums(w1, 1)
    w2_d, w2_s = planes_and_sums(w2, 0)
    v1_d, v1_s = planes_and_sums(v1, 1)
    v2_d, v2_s = planes_and_sums(v2, 0)
    scales = [pow(2, 32 * g, q) for g in range(4)]
    inv_a, inv_b = numth.invert_mod(A, q), numth.invert_mod(B, q)
    consts = ([q, (((1 << 128) // q) >> 64), nd, _m_off(q, nd, nd, A),
               _m_off(q, nd, nd, B)] + scales
              + [u.shoup_quotient(s, q) for s in scales]
              + [inv_a, u.shoup_quotient(inv_a, q), 0])
    roots = [with_shoup(t) for t in butterfly_tables_host(n, q)]
    itw_b = [int(x) * inv_b % q for x in itw.reshape(-1)]
    itw_b, itw_b_shoup = (t.reshape(A, B) for t in with_shoup(itw_b))
    return MxuNttTables(
        w1_digits=w1_d, w1_sums=w1_s, w2_digits=w2_d, w2_sums=w2_s,
        tw=to_torch(tw, dev), tw_shoup=to_torch(tws, dev),
        iw1_digits=v1_d, iw1_sums=v1_s, iw2_digits=v2_d, iw2_sums=v2_s,
        itw=to_torch(itw, dev), itw_shoup=to_torch(itws, dev),
        w2t_digits=w2_d.transpose(1, 2).contiguous(),
        iw2t_digits=v2_d.transpose(1, 2).contiguous(),
        consts=u.u64(consts, dev),
        a_roots=roots[0][0], a_roots_shoup=roots[0][1],
        a_inv_roots=roots[1][0], a_inv_roots_shoup=roots[1][1],
        b_roots=roots[2][0], b_roots_shoup=roots[2][1],
        b_inv_roots=roots[3][0], b_inv_roots_shoup=roots[3][1],
        itw_b=itw_b, itw_b_shoup=itw_b_shoup, n=n, a=A, b=B, modulus=q)


def make_mxu_tables(n: int, q: int, device) -> MxuNttTables:
    """J's tables of (n, q) on ``device``, made once per device: chain
    levels share primes, so each prime's planes are made and uploaded
    once."""
    A, B = _split_factors(n)
    if n < MXU_MIN_N or A > MAX_FACTOR:
        raise ValueError(f"J takes {MXU_MIN_N} <= n <= "
                         f"{MAX_FACTOR * MAX_FACTOR}, got n = {n}")
    return _make_mxu_tables(int(n), int(q), str(torch.device(device)))


def limb_planes(t: MxuNttTables, x_planes: int) -> int:
    """The X planes of one modulus under a caller's bound of x_planes
    planes: the bound where it is tighter than the modulus (the entry
    normalization is then skipped), else 0 (modulus-sized planes after a
    Barrett reduction) (troy_tpu/ops/ntt.py:334-340)."""
    return x_planes if 0 < x_planes <= t.planes else 0


# matrices and twiddle grids in csrc/ntt_mxu.cu's pointer table
_W1, _W2T, _V1, _V2T = 0, 1, 2, 3
_NO_TWIDDLE, _TW, _ITW = -1, 0, 1
# the stages of kernel J: (contracts the block's rows, matrix, twiddle grid,
# reduces its input words first); the forward transform is W1 with the
# twiddles, then W2, the inverse V2 with the inverse twiddles, then V1
STAGES = {
    "forward_left": (1, _W1, _TW, 1),
    "forward_right": (0, _W2T, _NO_TWIDDLE, 0),
    "inverse_right": (0, _V2T, _ITW, 1),
    "inverse_left": (1, _V1, _NO_TWIDDLE, 0),
}
FORWARD = ("forward_left", "forward_right")
INVERSE = ("inverse_right", "inverse_left")
# the stage argument of csrc/ntt_mxu.cu's entry point: STAGES' order
_STAGE_INDEX = {name: i for i, name in enumerate(STAGES)}


# --------------------------------------------------------------------------
# plain versions (the CPU path; on the card, the kernel's comparison)
# --------------------------------------------------------------------------

def _digits(x: torch.Tensor, ndig: int) -> torch.Tensor:
    """u64 words (..., R, C) -> (ndig, ..., R, C) int64 biased byte planes
    (byte_i - 128); the arithmetic shift of int64 keeps the byte's bits."""
    return torch.stack([((x >> 8 * i) & 0xFF) - 128 for i in range(ndig)])


def _mod_matmul_plain(w_digits: torch.Tensor, w_sums: torch.Tensor,
                      x: torch.Tensor, q: int, contract_left: bool,
                      x_planes: int = 0) -> torch.Tensor:
    """Exact (W @ X) mod q, or (X @ W) if not contract_left
    (troy_tpu/ops/ntt_mxu.py:263 _mod_matmul): w_digits (D, R, R) int8
    biased planes, w_sums (D, R) their sums over W's contraction axis, x
    (..., R, C) words below q (below 2^(8 x_planes) when given). The plane
    products are float64 matmuls, exact (module docstring)."""
    D = w_digits.shape[0]
    Dx = x_planes or D
    xd = _digits(x, Dx)                                  # (Dx, ..., R, C)
    K = x.shape[-2] if contract_left else x.shape[-1]
    xs = xd.sum(dim=-2 if contract_left else -1)         # (Dx, ..., C|R)
    lead = x.dim() - 2
    wf = w_digits.to(torch.float64).reshape(
        (D, 1) + (1,) * lead + w_digits.shape[1:])
    xf = xd.to(torch.float64).unsqueeze(0)               # (1, Dx, ..., R, C)
    prod = torch.matmul(wf, xf) if contract_left else torch.matmul(xf, wf)
    prod = prod.to(torch.int64)                          # (D, Dx, ..., r, c)
    ws = w_sums.to(torch.int64)
    n_sums = D + Dx - 1
    out = None
    for g in range((n_sums + 3) // 4):
        acc = torch.zeros_like(prod[0, 0])
        for r in range(4):
            s = 4 * g + r
            if s >= n_sums:
                continue
            ii = [i for i in range(D) if 0 <= s - i < Dx]
            total = sum(prod[i, s - i] for i in ii)
            wc = sum(ws[i] for i in ii)
            xc = sum(xs[s - i] for i in ii)
            if contract_left:      # total (..., R', C), wc (R',), xc (..., C)
                corr = 128 * wc[:, None] + 128 * xc.unsqueeze(-2)
            else:                  # total (..., R, C'), wc (C',), xc (..., R)
                corr = 128 * wc + 128 * xc.unsqueeze(-1)
            acc = acc + (total + corr + 128 * 128 * K * len(ii)) * (1 << 8 * r)
        scale = pow(2, 32 * g, q)
        term = u.mul_mod_shoup(acc + _m_off(q, D, Dx, K), scale,
                               u.shoup_quotient(scale, q), q)
        out = term if out is None else u.add_mod(out, term, q)
    return out


def mxu_stage_plain(x: torch.Tensor, mxu: Sequence[MxuNttTables],
                    stage: str, x_planes: int = 0) -> torch.Tensor:
    """One stage of the transform (``STAGES``) over every limb of x
    (..., k, R, C), each limb's (R, C) block as the stage reads it: the
    left stages contract its R rows (R = A), the right stages its C columns
    (C = B); the twiddle grid of the stage has the block's shape (a shard's
    block, ``shard_tables``). Fully reduced."""
    left, mat, tsel, reduce_in = STAGES[stage]
    rows = []
    for i, t in enumerate(mxu):
        q = t.modulus
        xi = x[..., i, :, :]
        planes = limb_planes(t, x_planes) if stage == "forward_left" else 0
        if reduce_in and not planes:
            xi = u.barrett_reduce_64(xi, q, ((1 << 128) // q) >> 64)
        digits, sums = {
            _W1: (t.w1_digits, t.w1_sums), _W2T: (t.w2_digits, t.w2_sums),
            _V1: (t.iw1_digits, t.iw1_sums),
            _V2T: (t.iw2_digits, t.iw2_sums)}[mat]
        y = _mod_matmul_plain(digits, sums, xi, q, bool(left), planes)
        if tsel == _TW:
            y = u.mul_mod_shoup(y, t.tw, t.tw_shoup, q)
        elif tsel == _ITW:
            y = u.mul_mod_shoup(y, t.itw, t.itw_shoup, q)
        rows.append(y)
    return torch.stack(rows, dim=-3)


def ntt_forward_mxu_plain(x: torch.Tensor, t: MxuNttTables,
                          x_planes: int = 0) -> torch.Tensor:
    """Forward NTT over the last axis (troy_tpu/ops/ntt_mxu.py:377): the
    butterfly's words, fully reduced. With x_planes, inputs below
    2^(8 x_planes) go in without the entry Barrett reduction."""
    lead = x.shape[:-1]
    y = x.reshape(lead + (1, t.a, t.b))
    for stage in FORWARD:
        y = mxu_stage_plain(y, (t,), stage, x_planes)
    return y.reshape(lead + (t.n,))


def ntt_inverse_mxu_plain(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """Inverse NTT over the last axis, n^-1 included
    (troy_tpu/ops/ntt_mxu.py:404), fully reduced."""
    lead = x.shape[:-1]
    y = x.reshape(lead + (1, t.a, t.b))
    for stage in INVERSE:
        y = mxu_stage_plain(y, (t,), stage)
    return y.reshape(lead + (t.n,))


def rns_ntt_mxu_plain(x: torch.Tensor, mxu: Sequence[MxuNttTables],
                      inverse: bool, x_planes: int = 0) -> torch.Tensor:
    """Every limb of (..., k, n), one limb at a time."""
    if inverse:
        rows = [ntt_inverse_mxu_plain(x[..., i, :], t)
                for i, t in enumerate(mxu)]
    else:
        rows = [ntt_forward_mxu_plain(x[..., i, :], t, x_planes)
                for i, t in enumerate(mxu)]
    return torch.stack(rows, dim=-2)


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------

def pointer_table(mxu: Sequence[MxuNttTables], device) -> torch.Tensor:
    """(k, 16) words: each limb's table addresses, for one launch over
    every limb."""
    return u.u64([p for t in mxu for p in t.pointers()],
                 device).reshape(len(mxu), 16)


def rns_mxu_stage(x: torch.Tensor, mxu: Sequence[MxuNttTables],
                  pointers: torch.Tensor, stage: str,
                  x_planes: int = 0) -> torch.Tensor:
    """One launch of kernel J: ``stage`` over every limb and leading row of
    x (..., k, R, C) (``mxu_stage_plain`` says what it computes), with
    ``pointers`` the limbs' ``pointer_table``; x_planes bounds the words of
    the forward transform's first stage (the plain version's planes; the
    kernel reduces every word it reads). Words fully reduced."""
    left, _, tsel, _ = STAGES[stage]
    R, C = x.shape[-2:]
    t0 = mxu[0]
    if x.dim() < 3 or x.shape[-3] != len(mxu) \
            or (R != t0.a if left else C != t0.b):
        raise ValueError(f"ntt_mxu {stage}: blocks {tuple(x.shape)} for "
                         f"{len(mxu)} limbs of ({t0.a}, {t0.b})")
    grid = {_TW: t0.tw, _ITW: t0.itw}.get(tsel)
    if grid is not None and grid.shape != (R, C):
        raise ValueError(f"ntt_mxu {stage}: twiddle grid "
                         f"{tuple(grid.shape)} for blocks of ({R}, {C})")
    if not _kernels.on_cuda(x, pointers):
        return mxu_stage_plain(x, mxu, stage, x_planes)
    x = x.contiguous()
    _kernels.check_operand(x, "ntt_mxu input")
    out = torch.empty_like(x)
    _kernels.launch("troy_ntt_mxu", out.get_device(), out, x,
                    x.numel() // (R * C), len(mxu), R.bit_length() - 1,
                    C.bit_length() - 1, pointers, _STAGE_INDEX[stage])
    return out


def rns_ntt_mxu(x: torch.Tensor, t, inverse: bool,
                x_planes: int = 0) -> torch.Tensor:
    """Kernel J over every limb of x (..., k, n), with t the base's
    ops/ntt.RnsNttTables (its ``mxu`` tables and ``mxu_pointers``):
    forward (W1 with the twiddles, then W2) or inverse (V2 with the inverse
    twiddles, then V1), one launch per stage for the whole batch. Any u64
    words in; with x_planes, words below 2^(8 x_planes) (limbs whose
    modulus is narrower take the Barrett path). Output fully reduced."""
    if not _kernels.on_cuda(x, t.q):
        return rns_ntt_mxu_plain(x, t.mxu, inverse, x_planes)
    t0 = t.mxu[0]
    y = x.reshape(x.shape[:-1] + (t0.a, t0.b))
    for stage in INVERSE if inverse else FORWARD:
        y = rns_mxu_stage(y, t.mxu, t.mxu_pointers, stage, x_planes)
    return y.reshape(x.shape)


# --------------------------------------------------------------------------
# a shard of the transform (the coefficient-sharded regime)
# --------------------------------------------------------------------------

def shard_tables(t: MxuNttTables, parts: int, index: int) -> MxuNttTables:
    """The tables of shard ``index`` of ``parts`` of the 4-step transform:
    the forward twiddles' column block (A, B/parts), which the forward
    left stage multiplies into a column block of C, and the inverse
    twiddles' row block (A/parts, B), which the inverse right stage
    multiplies into a row block (a contiguous run of n/parts words), with
    the kernel's inverse grid over B; the factor matrices and butterfly
    tables whole (troy_tpu/ops/ntt_mxu.py:68 _split_factors,
    troy_tpu/parallel/sharding.py:203)."""
    if t.a % parts or t.b % parts:
        raise ValueError(f"4-step factors ({t.a}, {t.b}) do not split "
                         f"{parts} ways")
    cb, rb = t.b // parts, t.a // parts
    cols = slice(index * cb, (index + 1) * cb)
    rows = slice(index * rb, (index + 1) * rb)
    return dataclasses.replace(
        t, tw=t.tw[:, cols].contiguous(),
        tw_shoup=t.tw_shoup[:, cols].contiguous(),
        itw=t.itw[rows].contiguous(), itw_shoup=t.itw_shoup[rows].contiguous(),
        itw_b=t.itw_b[rows].contiguous(),
        itw_b_shoup=t.itw_b_shoup[rows].contiguous())


def make_shard_tables(n: int, q: int, device, parts: int,
                      index: int) -> MxuNttTables:
    """``shard_tables`` of J's tables of (n, q) on ``device``. The plain
    version takes any n; kernel J's tiles need the blocks at least 32 on
    each side (a left tile is up to 32 columns wide, a right tile 2048 / B
    rows high), so on a card A / parts and B / parts must be at least 32
    (n = 16384 over up to 4 ranks, n = 131072 over up to 8)."""
    A, B = _split_factors(n)
    device = torch.device(device)
    if A > MAX_FACTOR or (device.type == "cuda"
                          and min(A, B) // parts < 32):
        raise ValueError(f"J's shard of n = {n} over {parts} ranks: blocks "
                         f"of ({A // parts}, {B // parts}) are below the "
                         "kernel's 32-line tiles")
    return shard_tables(_make_mxu_tables(int(n), int(q), str(device)), parts,
                        index)
