"""Negacyclic NTT and dyadic products on torch tensors.

The port of troy_tpu/ops/ntt.py. A polynomial in RNS form is a (..., k, n)
int64 tensor of u64 words, limb-major; the tables of an RNS base stack the
per-limb root powers as (k, n) and the per-limb constants as (k,) tensors
on the context's device.

Each transform has a plain PyTorch version (the Harvey butterfly network of
the JAX package, written on the int64 u64ops twin) and a CUDA kernel:
kernel A (csrc/ntt.cu) for the transforms and kernel B (csrc/dyadic_mac.cu)
for the dyadic products. A wrapper runs the plain version for tensors on
the CPU and launches the kernel for tensors on CUDA.

Tables made with J's factor matrices (``use_mxu``) run every transform on
kernel J instead (ops/ntt_mxu.py: the JAX package's 4-step transform at
n >= 2048, its stages as butterflies in shared memory). ``use_mxu``:
True, J at any n >= 2048; False, A at any n; None, the default, A up to
``MAX_KERNEL_N`` and J above.

A runs one pass over whole rows below n = 1024 and two passes from it up
(a strided and a contiguous one, csrc/ntt.cu); the crossover was measured
on the H100 (PERF.md).

Ordering contract (shared with the encoder): forward output index j holds
the evaluation at psi^(2*brv(j) + 1); the forward transform takes natural
order to bit-reversed order and the inverse undoes it, n^-1 included.
Lazy outputs: forward in [0, 4q), inverse in [0, 2q) on A; J returns
reduced words even when lazy, as the JAX package's MXU path does, and every
caller reduces afterwards, so end results are the same words.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ntt_mxu
from . import u64ops as u
from .. import _kernels
from ..interop import to_torch
from ..utils.ntt_tables import make_ntt_tables

# The largest n the default (use_mxu=None) runs on A; J above. Measured on
# the H100 (chip_smoke.py phase 35, A and J in turns, device time a
# forward call): A the faster at n = 32768, 65536 and 131072 by 3-8 %, J
# at 262144 by 17-19 %; at 16384 J's edge (1-5 % at the headline's rows)
# is inside the spread and its wrapper's host time is 1.4-1.7 times A's,
# so the smaller rings stay on A (PERF.md section 7).
MAX_KERNEL_N = 131072


@dataclass(eq=False)
class RnsNttTables:
    """Stacked NTT tables of an RNS base (k limbs, one shared n)."""

    root_powers: torch.Tensor            # (k, n)
    root_powers_shoup: torch.Tensor      # (k, n)
    inv_root_powers: torch.Tensor        # (k, n)
    inv_root_powers_shoup: torch.Tensor  # (k, n)
    q: torch.Tensor                      # (k,) moduli
    cr_hi: torch.Tensor                  # (k,) Barrett ratio, high word
    cr_lo: torch.Tensor                  # (k,) Barrett ratio, low word
    inv_degree: torch.Tensor             # (k,) n^-1 mod q
    inv_degree_shoup: torch.Tensor       # (k,)
    n: int
    log_n: int
    values: Tuple[int, ...]
    # kernel J's tables, one per limb, when the transforms run on J
    mxu: Optional[Tuple[ntt_mxu.MxuNttTables, ...]] = None
    # sub-bases and scalar operands made from these tables, by key
    _memo: Dict[tuple, object] = field(default_factory=dict, repr=False)

    @classmethod
    def from_moduli(cls, n: int, moduli: Sequence[int], device,
                    use_mxu: Optional[bool] = None) -> "RnsNttTables":
        """The tables of a base on ``device``; with J's tables when
        ``use_mxu`` asks for them (module docstring)."""
        n = int(n)
        values = tuple(int(q) for q in moduli)
        if use_mxu is None:
            use_mxu = n > MAX_KERNEL_N
        mxu = tuple(ntt_mxu.make_mxu_tables(n, q, device)
                    for q in values) if use_mxu else None
        hosts = [make_ntt_tables(n, q) for q in values]
        stack = lambda get: to_torch(np.stack([get(h) for h in hosts]),
                                     device)
        vec = lambda get: to_torch(np.array(
            [get(h) & u.M64 for h in hosts], dtype=np.uint64), device)
        return cls(
            root_powers=stack(lambda h: h.root_powers),
            root_powers_shoup=stack(lambda h: h.root_powers_shoup),
            inv_root_powers=stack(lambda h: h.inv_root_powers),
            inv_root_powers_shoup=stack(lambda h: h.inv_root_powers_shoup),
            q=vec(lambda h: h.modulus),
            cr_hi=vec(lambda h: h.const_ratio[1]),
            cr_lo=vec(lambda h: h.const_ratio[0]),
            inv_degree=vec(lambda h: h.inv_degree),
            inv_degree_shoup=vec(lambda h: h.inv_degree_shoup),
            n=n, log_n=n.bit_length() - 1, values=values, mxu=mxu)

    @classmethod
    def concat(cls, a: "RnsNttTables", b: "RnsNttTables") -> "RnsNttTables":
        """The tables of a's limbs then b's, as one base (the same words
        as tables made from both moduli lists); on J if both are."""
        cat = lambda name: torch.cat([getattr(a, name), getattr(b, name)])
        if (a.mxu is None) != (b.mxu is None):
            raise ValueError("concat: one base runs on J and the other not")
        names = ("root_powers", "root_powers_shoup", "inv_root_powers",
                 "inv_root_powers_shoup", "q", "cr_hi", "cr_lo", "inv_degree",
                 "inv_degree_shoup")
        return cls(**{name: cat(name) for name in names}, n=a.n,
                   log_n=a.log_n, values=a.values + b.values,
                   mxu=None if a.mxu is None else a.mxu + b.mxu)

    @property
    def k(self) -> int:
        return len(self.values)

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def mxu_pointers(self) -> torch.Tensor:
        """J's pointer table of these limbs (ops/ntt_mxu.pointer_table),
        made once."""
        if "mxu_pointers" not in self._memo:
            self._memo["mxu_pointers"] = ntt_mxu.pointer_table(self.mxu,
                                                               self.device)
        return self._memo["mxu_pointers"]

    def _sub(self, key: tuple, index) -> "RnsNttTables":
        if key not in self._memo:
            take = lambda a: a[index].contiguous()
            limbs = list(range(self.k))[index] if isinstance(index, slice) \
                else index
            self._memo[key] = RnsNttTables(
                root_powers=take(self.root_powers),
                root_powers_shoup=take(self.root_powers_shoup),
                inv_root_powers=take(self.inv_root_powers),
                inv_root_powers_shoup=take(self.inv_root_powers_shoup),
                q=take(self.q), cr_hi=take(self.cr_hi), cr_lo=take(self.cr_lo),
                inv_degree=take(self.inv_degree),
                inv_degree_shoup=take(self.inv_degree_shoup),
                n=self.n, log_n=self.log_n,
                values=tuple(self.values[i] for i in limbs),
                mxu=None if self.mxu is None
                else tuple(self.mxu[i] for i in limbs))
        return self._memo[key]

    def select(self, indices: Sequence[int]) -> "RnsNttTables":
        """Sub-base over an arbitrary limb index set, e.g. the key-switch
        working base {q_0..q_{k-1}, p_special}. Made once per index set."""
        indices = tuple(int(i) for i in indices)
        return self._sub(("select", indices), list(indices))

    def slice(self, start: int, stop: int) -> "RnsNttTables":
        """Sub-base over limbs [start, stop)."""
        return self._sub(("slice", start, stop), slice(start, stop))

    def pointwise(self, n: int) -> "RnsNttTables":
        """This base for the pointwise kernels (B, D, F, R1) over rows of
        n words, a coefficient shard of the ring: the moduli and their
        constants without the transform's tables, so a transform of it
        raises. Made once per n."""
        key = ("pointwise", n)
        if key not in self._memo:
            none = self.root_powers[:, :0]
            self._memo[key] = RnsNttTables(
                root_powers=none, root_powers_shoup=none,
                inv_root_powers=none, inv_root_powers_shoup=none, q=self.q,
                cr_hi=self.cr_hi, cr_lo=self.cr_lo,
                inv_degree=self.inv_degree,
                inv_degree_shoup=self.inv_degree_shoup, n=n,
                log_n=n.bit_length() - 1, values=self.values)
        return self._memo[key]

    def limb(self, i: int) -> "NttTables":
        """Single-modulus view of limb i."""
        key = ("limb", i)
        if key not in self._memo:
            self._memo[key] = NttTables(self.slice(i, i + 1))
        return self._memo[key]

    def scalar_operand(self, scalars: Sequence[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-limb (s_i mod q_i, Shoup quotient) as two (k,) tensors, for
        rns_scalar_mul; made once per scalar list."""
        scalars = tuple(int(s) for s in scalars)
        key = ("scalar", scalars)
        if key not in self._memo:
            w = [s % q for s, q in zip(scalars, self.values)]
            wq = [u.shoup_quotient(x, q) for x, q in zip(w, self.values)]
            self._memo[key] = (u.u64(w, self.device), u.u64(wq, self.device))
        return self._memo[key]


@dataclass(eq=False)
class NttTables:
    """Tables of one modulus (e.g. the plain modulus t of the batching
    encoder): a one-limb RNS base whose transforms act on (..., n)."""

    rns: RnsNttTables

    @classmethod
    def from_modulus(cls, n: int, modulus: int, device,
                     use_mxu: Optional[bool] = None) -> "NttTables":
        return cls(RnsNttTables.from_moduli(n, (modulus,), device, use_mxu))

    @property
    def n(self) -> int:
        return self.rns.n

    @property
    def modulus(self) -> int:
        return self.rns.values[0]


# --------------------------------------------------------------------------
# plain versions (the CPU path; on the card, the kernels' comparison)
# --------------------------------------------------------------------------

def _col(t: torch.Tensor, lead: int, extra: int) -> torch.Tensor:
    """(k,) -> broadcastable (1,)*lead + (k,) + (1,)*extra."""
    return t.reshape((1,) * lead + (t.shape[0],) + (1,) * extra)


def ntt_forward_plain(x: torch.Tensor, t: RnsNttTables,
                      lazy: bool = False) -> torch.Tensor:
    """The butterfly network of troy_tpu ops/ntt.py rns_ntt_forward."""
    n, k = t.n, t.k
    lead = x.shape[:-2]
    L = len(lead)
    q = _col(t.q, L, 2)
    q2 = 2 * q
    v = x
    for r in range(t.log_n):
        m = 1 << r
        gap = n >> (r + 1)
        w = t.root_powers[:, m:2 * m].reshape((1,) * L + (k, m, 1))
        wq = t.root_powers_shoup[:, m:2 * m].reshape((1,) * L + (k, m, 1))
        v = v.reshape(lead + (k, m, 2, gap))
        a = v[..., 0, :]
        b = v[..., 1, :]
        a = torch.where(a >= q2, a - q2, a)
        bw = b * w - u.mulhi64(b, wq) * q          # Shoup lazy, [0, 2q)
        v = torch.stack([a + bw, a - bw + q2], dim=-2).reshape(lead + (k, n))
    if not lazy:
        v = u.reduce_4q(v, _col(t.q, L, 1))
    return v


def ntt_inverse_plain(x: torch.Tensor, t: RnsNttTables,
                      lazy: bool = False) -> torch.Tensor:
    """The butterfly network of troy_tpu ops/ntt.py rns_ntt_inverse."""
    n, k = t.n, t.k
    lead = x.shape[:-2]
    L = len(lead)
    q = _col(t.q, L, 2)
    q2 = 2 * q
    v = x
    for r in range(t.log_n - 1, -1, -1):
        m = 1 << r
        gap = n >> (r + 1)
        w = t.inv_root_powers[:, m:2 * m].reshape((1,) * L + (k, m, 1))
        wq = t.inv_root_powers_shoup[:, m:2 * m].reshape((1,) * L + (k, m, 1))
        v = v.reshape(lead + (k, m, 2, gap))
        a = v[..., 0, :]
        b = v[..., 1, :]
        s = a + b
        d = a - b + q2
        s = torch.where(s >= q2, s - q2, s)
        bw = d * w - u.mulhi64(d, wq) * q
        v = torch.stack([s, bw], dim=-2).reshape(lead + (k, n))
    qn = _col(t.q, L, 1)
    v = u.mul_mod_shoup_lazy(v, _col(t.inv_degree, L, 1),
                             _col(t.inv_degree_shoup, L, 1), qn)
    if not lazy:
        v = u.reduce_2q(v, qn)
    return v


def key_rows_plain(b: torch.Tensor, k: int) -> torch.Tensor:
    """The k rows of b (..., kb, n) that kernel B reads: all of them where
    kb = k, else the first k - 1 and the last (a switching key's rows at a
    level below the first: the level's primes, then the special prime)."""
    if b.shape[-2] == k:
        return b
    return torch.cat([b[..., :k - 1, :], b[..., -1:, :]], dim=-2)


def dyadic_mac_plain(a: torch.Tensor, b: torch.Tensor, t: RnsNttTables,
                     addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(addend + sum_j a[j] * b[j]) mod q per limb, 128-bit sum then
    Barrett-128. a: (J, ..., k, n) broadcasting against b: (J, ..., k, n);
    addend (words below 2^63) broadcasting against the result."""
    lo = hi = None
    for j in range(a.shape[0]):
        plo, phi = u.mul128(a[j], b[j])
        lo, hi = (plo, phi) if lo is None else u.add_u128(lo, hi, plo, phi)
    if addend is not None:
        lo, hi = u.add_u128(lo, hi, addend, torch.zeros_like(addend))
    L = lo.dim() - 2
    return u.barrett_reduce_128(lo, hi, _col(t.q, L, 1), _col(t.cr_lo, L, 1),
                                _col(t.cr_hi, L, 1))


def dyadic_convolve_plain(a: torch.Tensor, b: torch.Tensor,
                          t: RnsNttTables) -> torch.Tensor:
    """The ciphertext-degree convolution out[..., m] = sum_{i + i' = m}
    a[..., i] * b[..., i'] mod q per limb: a (..., s1, k, n), b (..., s2, k,
    n) -> (..., s1 + s2 - 1, k, n), each output component's terms summed
    in 128 bits (``dyadic_mac_plain``)."""
    s1, s2 = a.shape[-3], b.shape[-3]
    a, b = a.movedim(-3, 0), b.movedim(-3, 0)        # components first
    outs = []
    for m in range(s1 + s2 - 1):
        lo, hi = max(0, m - s2 + 1), min(s1, m + 1)      # i in [lo, hi)
        outs.append(dyadic_mac_plain(a[lo:hi], b[m - hi + 1:m - lo + 1]
                                     .flip(0), t))
    return torch.stack(outs, dim=-3)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check_rows(x: torch.Tensor, t: RnsNttTables, name: str) -> None:
    if x.dim() < 2 or x.shape[-2] != t.k or x.shape[-1] != t.n:
        raise ValueError(f"{name}: expected (..., {t.k}, {t.n}), "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 u64 words, got {x.dtype}")


def _ntt(x: torch.Tensor, t: RnsNttTables, inverse: bool, lazy: bool,
         x_bound_bits: Optional[int] = None) -> torch.Tensor:
    _check_rows(x, t, "ntt")
    if t.root_powers.shape[-1] != t.n:
        raise ValueError("ntt: these tables hold no transform (a pointwise "
                         "view of a base)")
    if t.mxu is not None:
        planes = 0 if x_bound_bits is None \
            else ntt_mxu._ndigits_value((1 << x_bound_bits) - 1)
        return ntt_mxu.rns_ntt_mxu(x, t, inverse, planes)
    if not _kernels.on_cuda(x, t.q):
        plain = ntt_inverse_plain if inverse else ntt_forward_plain
        return plain(x, t, lazy)
    if not x.is_contiguous():
        x = x.contiguous()
    _kernels.check_operand(x, "ntt input")
    out = torch.empty_like(x)
    if inverse:
        roots, shoup = t.inv_root_powers, t.inv_root_powers_shoup
    else:
        roots, shoup = t.root_powers, t.root_powers_shoup
    _kernels.launch("troy_ntt", out.get_device(), out, x, x.numel() // t.n,
                    t.log_n, t.k, roots, shoup, t.q, t.inv_degree,
                    t.inv_degree_shoup, int(inverse), int(lazy))
    return out


def launch_blocks(rows: int, n: int, inverse: bool = False
                  ) -> Tuple[int, ...]:
    """The blocks of each of A's launches for one transform of ``rows``
    rows of n words (the card's library)."""
    blocks = (ctypes.c_longlong * 2)()
    _kernels.library()
    count = _kernels._entries["troy_ntt_blocks"](
        rows, n.bit_length() - 1, int(inverse), ctypes.addressof(blocks))
    return tuple(blocks[:count])


def inverse_decrypt_plan(comps: int, k: int, n: int,
                         bfv: bool) -> Tuple[int, ...]:
    """The plan of the fused decrypt's last inverse pass (ACi if ``bfv``,
    else AXi) over ``comps`` components of k rows of n words (the card's
    library, no launch): (log2 of a line's words, log2 of a block's
    columns, the rows a block holds, log2 of a tile's threads, blocks).
    The fused entries launch only where a block holds the k rows."""
    plan = (ctypes.c_longlong * 5)()
    _kernels.library()
    status = _kernels._entries["troy_ntt_inverse_decrypt_plan"](
        comps, k, n.bit_length() - 1, int(bfv), ctypes.addressof(plan))
    if status != 0:
        raise ValueError(f"no fused decrypt plan for {comps} x {k} rows at "
                         f"n = {n}")
    return tuple(plan)


def rns_ntt_forward(x: torch.Tensor, t: RnsNttTables, lazy: bool = False,
                    x_bound_bits: Optional[int] = None) -> torch.Tensor:
    """Forward NTT of every limb: (..., k, n) -> (..., k, n). Input words
    below 4q; output in [0, q), or [0, 4q) if lazy (A only).

    x_bound_bits: the caller's bound, every input word below
    2^x_bound_bits (any representative of its residue). On J a limb whose
    modulus is at least that wide then takes the words as they are, with
    fewer X planes (troy_tpu/ops/ntt.py:318-343); A ignores it."""
    return _ntt(x, t, inverse=False, lazy=lazy, x_bound_bits=x_bound_bits)


def ntt_forward_digits_plain(x: torch.Tensor,
                             t: RnsNttTables) -> torch.Tensor:
    """The plain version of ``rns_ntt_forward_digits``: the key switch's
    digits (kernel F's plain version), then the forward butterfly
    network."""
    from .keyswitch import keyswitch_digits_plain   # keyswitch imports ntt
    return ntt_forward_plain(keyswitch_digits_plain(x, t), t)


def rns_ntt_forward_digits(x: torch.Tensor, t: RnsNttTables) -> torch.Tensor:
    """The key switch's digits, transformed (kernel F's digits folded into
    kernel A's first pass, one A call): (..., n) words -> (..., t.k, n),
    out[..., j, :] the forward NTT of x mod the j-th prime of t. Any u64
    input words; output fully reduced. A's route only: tables on J
    raise."""
    if x.dim() < 1 or x.shape[-1] != t.n:
        raise ValueError(f"rns_ntt_forward_digits: expected (..., {t.n}), "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.int64:
        raise TypeError(f"rns_ntt_forward_digits: expected int64 u64 words, "
                        f"got {x.dtype}")
    if t.mxu is not None or t.root_powers.shape[-1] != t.n:
        raise ValueError("rns_ntt_forward_digits: these tables hold no "
                         "transform on A (kernel J's, or a pointwise view)")
    if not _kernels.on_cuda(x, t.q):
        return ntt_forward_digits_plain(x, t)
    x = x.contiguous()
    _kernels.check_operand(x, "rns_ntt_forward_digits input")
    out = torch.empty(x.shape[:-1] + (t.k, t.n), dtype=torch.int64,
                      device=x.device)
    _kernels.launch("troy_ntt_forward_digits", out.get_device(), out, x,
                    out.numel() // t.n, t.log_n, t.k, t.root_powers,
                    t.root_powers_shoup, t.q, t.cr_hi)
    return out


def on_a_route(t: RnsNttTables) -> bool:
    """Whether these tables' transforms run on kernel A, whose passes take
    the fused loads and finishes (AF, AGp, AP2i): not J's, not a pointwise
    view."""
    return t.mxu is None and t.root_powers.shape[-1] == t.n


def ntt_forward_lift_plain(m: torch.Tensor, t: RnsNttTables,
                           plain_modulus: int, threshold: int, total_q: int,
                           correction_factor: int = 1) -> torch.Tensor:
    """The plain version of ``rns_ntt_forward_lift``: kernel G''s plain
    version, then the forward butterfly network."""
    from .poly import plain_lift_plain              # poly imports ntt
    return ntt_forward_plain(plain_lift_plain(
        m, t, plain_modulus, threshold, total_q, correction_factor), t)


def rns_ntt_forward_lift(m: torch.Tensor, t: RnsNttTables,
                         plain_modulus: int, threshold: int, total_q: int,
                         correction_factor: int = 1) -> torch.Tensor:
    """The plain lift, transformed (kernel G''s lift folded into kernel A's
    first pass, AGp, one A call): m (..., n) words mod t -> (..., t.k, n),
    out[..., j, :] the forward NTT of m (times cf mod t first where the
    correction factor is not 1) lifted centred into the j-th prime of t:
    coefficients at or above the threshold ((t+1)/2 for the plain ops, t
    for the BGV encrypt's raw residues) stand for m - t. Fully reduced.
    A's route only: tables on J, or a pointwise view, raise."""
    if m.dim() < 1 or m.shape[-1] != t.n:
        raise ValueError(f"rns_ntt_forward_lift: expected (..., {t.n}), got "
                         f"{tuple(m.shape)}")
    if m.dtype != torch.int64:
        raise TypeError(f"rns_ntt_forward_lift: expected int64 u64 words, "
                        f"got {m.dtype}")
    if not on_a_route(t):
        raise ValueError("rns_ntt_forward_lift: these tables hold no "
                         "transform on A (kernel J's, or a pointwise view)")
    from .poly import plain_lift_consts
    consts = plain_lift_consts(t, plain_modulus, total_q)
    if not _kernels.on_cuda(m, consts):
        return ntt_forward_lift_plain(m, t, plain_modulus, threshold,
                                      total_q, correction_factor)
    m = m.contiguous()
    _kernels.check_operand(m, "rns_ntt_forward_lift m")
    cf = correction_factor % plain_modulus
    out = torch.empty(m.shape[:-1] + (t.k, t.n), dtype=torch.int64,
                      device=m.device)
    _kernels.launch("troy_ntt_forward_lift", out.get_device(), out, m,
                    out.numel() // t.n, t.log_n, t.k, t.root_powers,
                    t.root_powers_shoup, t.q, consts, threshold, cf,
                    u.shoup_quotient(cf, plain_modulus))
    return out


def ntt_inverse_pair_convolve_plain(a: torch.Tensor, w: torch.Tensor,
                                    t: RnsNttTables) -> torch.Tensor:
    """The plain version of ``rns_ntt_inverse_pair_convolve``: kernel P2's
    plain version, then the inverse butterfly network."""
    from .tiles import tile_pair_convolve_plain     # tiles imports ntt
    return ntt_inverse_plain(tile_pair_convolve_plain(a, w, t), t)


# ciphertext components a side the pair kernels take (P2's, AP2i's)
PAIR_MAX_COMPS = 4


def _check_pair(a: torch.Tensor, w: torch.Tensor, t: RnsNttTables,
                name: str) -> None:
    _check_rows(a, t, f"{name} a")
    _check_rows(w, t, f"{name} w")
    if a.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: a {tuple(a.shape)} and w "
                         f"{tuple(w.shape)}: expected (X, s, R, n) each")
    if max(a.shape[1], w.shape[1]) > PAIR_MAX_COMPS:
        raise ValueError(f"{name}: sizes {a.shape[1]} and {w.shape[1]}; at "
                         f"most {PAIR_MAX_COMPS}")


def rns_ntt_inverse_pair_convolve(a: torch.Tensor, w: torch.Tensor,
                                  t: RnsNttTables) -> torch.Tensor:
    """The inverse transform of every pair's ciphertext-degree convolution
    of an X x Yc grid (kernel P2 folded into kernel A's first inverse
    pass, AP2i, one A call): a (X, s1, R, n) and w (Yc, s2, R, n) in the
    NTT domain, words below 4q, sizes at most 4; R rows over the moduli of
    t (q u Bsk: BFV's product grid). Out (X, Yc, s1 + s2 - 1, R, n), the
    coefficient form of sum_{i + i' = m} a[x, i] * w[y, i'], fully
    reduced. A's route only: tables on J, or a pointwise view, raise."""
    _check_pair(a, w, t, "rns_ntt_inverse_pair_convolve")
    if not on_a_route(t):
        raise ValueError("rns_ntt_inverse_pair_convolve: these tables hold "
                         "no transform on A (kernel J's, or a pointwise "
                         "view)")
    if not _kernels.on_cuda(a, w, t.q):
        return ntt_inverse_pair_convolve_plain(a, w, t)
    X, Y, s1, s2 = a.shape[0], w.shape[0], a.shape[1], w.shape[1]
    a, w = a.contiguous(), w.contiguous()
    _kernels.check_operand(a, "rns_ntt_inverse_pair_convolve a")
    _kernels.check_operand(w, "rns_ntt_inverse_pair_convolve w")
    out = torch.empty((X, Y, s1 + s2 - 1, t.k, t.n), dtype=torch.int64,
                      device=a.device)
    _kernels.launch("troy_ntt_inverse_pair_convolve", out.get_device(), out,
                    a, w, X, Y, s1, s2, t.k, t.log_n, t.inv_root_powers,
                    t.inv_root_powers_shoup, t.q, t.cr_lo, t.cr_hi,
                    t.inv_degree, t.inv_degree_shoup)
    return out


def rns_ntt_inverse(x: torch.Tensor, t: RnsNttTables,
                    lazy: bool = False) -> torch.Tensor:
    """Inverse NTT of every limb, n^-1 included. Input words below 2q;
    output in [0, q), or [0, 2q) if lazy."""
    return _ntt(x, t, inverse=True, lazy=lazy)


def ntt_forward(x: torch.Tensor, t: NttTables,
                lazy: bool = False) -> torch.Tensor:
    """Single-modulus forward NTT over the last axis (kernel A or J,
    k = 1)."""
    return rns_ntt_forward(x.unsqueeze(-2), t.rns, lazy).squeeze(-2)


def ntt_inverse(x: torch.Tensor, t: NttTables,
                lazy: bool = False) -> torch.Tensor:
    """Single-modulus inverse NTT over the last axis (kernel A or J,
    k = 1)."""
    return rns_ntt_inverse(x.unsqueeze(-2), t.rns, lazy).squeeze(-2)


def ntt_forward_limb(x: torch.Tensor, t: RnsNttTables, i: int,
                     lazy: bool = False) -> torch.Tensor:
    """Forward NTT of limb i of an RNS base: (..., n) -> (..., n)."""
    return ntt_forward(x, t.limb(i), lazy)


def ntt_inverse_limb(x: torch.Tensor, t: RnsNttTables, i: int,
                     lazy: bool = False) -> torch.Tensor:
    """Inverse NTT of limb i of an RNS base: (..., n) -> (..., n)."""
    return ntt_inverse(x, t.limb(i), lazy)


# the terms one sum of kernel B takes (reduced words; lazy words: four)
MAC_MAX_TERMS = 64


def _run_pitch(x: torch.Tensor, lo: int, hi: int) -> Optional[int]:
    """The pitch in words of axes lo .. hi - 1 of x read as one axis (0
    where they hold one element), or None where their strides do not
    allow it."""
    count, pitch = 1, 0
    for d in range(hi - 1, lo - 1, -1):
        if x.shape[d] == 1:
            continue
        if count == 1:
            pitch = x.stride(d)
        elif x.stride(d) != pitch * count:
            return None
        count *= x.shape[d]
    return pitch


def _in_place(x: torch.Tensor, runs, n: int, name: str):
    """(x, the pitch of each run of axes (lo, hi), 0 for a run None) as
    kernel B reads an operand: rows of n contiguous words, each run one
    axis of even pitch, the address 16-byte aligned. x itself where its
    strides allow that (a level's slice of a key), else a contiguous
    copy."""
    def pitches_of(x):
        return [0 if r is None else _run_pitch(x, *r) for r in runs]

    pitches = pitches_of(x)
    if not (x.stride(-1) == 1 and (x.shape[-2] == 1 or x.stride(-2) == n)
            and x.data_ptr() & 15 == 0
            and all(p is not None and p % 2 == 0 for p in pitches)):
        x = x.contiguous()
        x = x.clone() if x.data_ptr() & 15 else x
        pitches = pitches_of(x)
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 u64 words, got {x.dtype}")
    return x, pitches


def _launch_mac(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                addend: Optional[torch.Tensor], t: RnsNttTables, terms: int,
                comps: int, groups: int, a_runs, b_runs, add_runs,
                o_pitches: Tuple[int, int], name: str) -> torch.Tensor:
    """One kernel-B mac launch. runs (``_in_place``): a's (term, group)
    axes, b's (term, component, group) axes (group None: every group reads
    the same key), the addend's (component, group) axes."""
    if t.n < 2:
        raise ValueError(f"{name}: n = {t.n}: the kernel takes n >= 2")
    a, (a_term, a_group) = _in_place(a, a_runs, t.n, f"{name} a")
    b, (b_term, b_comp, b_group) = _in_place(b, b_runs, t.n, f"{name} b")
    add_comp = add_group = 0
    if addend is not None:
        addend, (add_comp, add_group) = _in_place(addend, add_runs, t.n,
                                                  f"{name} addend")
    _kernels.check_operand(out, f"{name} out")
    _kernels.launch("troy_dyadic_mac", out.get_device(), out, a, b, addend,
                    terms, comps, groups, t.k, t.log_n, a_term, a_group,
                    b_term, b_comp, b_group, b.shape[-2] - 1, add_comp,
                    add_group, o_pitches[0], o_pitches[1], t.q, t.cr_lo,
                    t.cr_hi)
    return out


def dyadic_mac(a: torch.Tensor, b: torch.Tensor, t: RnsNttTables,
               out: Optional[torch.Tensor] = None,
               addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out = (addend + sum_j a[j] * b[j]) mod q per limb (kernel B, one
    launch).

    a: (J, ..., k, n) and b: (J, C..., ..., kb, n), whose rows are
    (..., k, n) stacks; a broadcasts over b's extra leading axes C (the two
    key components of the key switch share one decomposed target). kb is
    k, or more: then the rows read are b's first k - 1 and its last (a
    switching key's rows at a level below the first: the level's primes,
    then the special prime). The sum must fit 128 bits: any words for one
    term, lazy words below 4q (< 2^63) for up to four, reduced words for
    up to 64. The addend (the output's shape, words below 2^63; the
    decrypt's c0) joins the sum, so the result is the canonical residue of
    addend + sum, the words of a modular add after it for an addend below
    q. Output (C..., ..., k, n), fully reduced; into ``out`` (contiguous,
    overlapping no input) if given. Each operand is read through its
    strides where its rows are contiguous (a key's level slice), else from
    a contiguous copy."""
    if a.shape[0] != b.shape[0] or a.shape[0] < 1 \
            or a.shape[0] > MAC_MAX_TERMS:
        raise ValueError(f"dyadic_mac: terms {a.shape[0]} vs {b.shape[0]}")
    _check_rows(a, t, "dyadic_mac a")
    extra = b.dim() - a.dim()
    if extra < 0 or a.shape[1:-2] != b.shape[extra + 1:-2] \
            or b.shape[-1] != t.n or b.shape[-2] < t.k:
        raise ValueError(f"dyadic_mac: {tuple(a.shape)} does not broadcast "
                         f"over {tuple(b.shape)}")
    shape = b.shape[1:-2] + (t.k, t.n)
    if addend is not None and addend.shape != shape:
        raise ValueError(f"dyadic_mac: addend {tuple(addend.shape)}, "
                         f"expected {tuple(shape)}")
    if out is not None and out.shape != shape:
        raise ValueError(f"dyadic_mac: out {tuple(out.shape)}")
    if not _kernels.on_cuda(a, b, t.q,
                            *([] if addend is None else [addend])):
        a_b = a.reshape(a.shape[:1] + (1,) * extra + a.shape[1:])
        res = dyadic_mac_plain(a_b, key_rows_plain(b, t.k), t, addend)
        return res if out is None else out.copy_(res)
    d = a.dim()
    comps = math.prod(b.shape[1:extra + 1])
    groups = math.prod(a.shape[1:-2])
    if out is None:
        out = torch.empty(shape, dtype=torch.int64, device=b.device)
    return _launch_mac(out, a, b, addend, t, a.shape[0], comps, groups,
                       [(0, 1), (1, d - 2)],
                       [(0, 1), (1, extra + 1), (extra + 1, b.dim() - 2)],
                       [(0, extra), (extra, addend.dim() - 2)]
                       if addend is not None else None,
                       (groups * t.k * t.n, t.k * t.n), "dyadic_mac")


def dyadic_mac_batched(key: torch.Tensor, targets: torch.Tensor,
                       t: RnsNttTables,
                       addend: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The key switch's inner product of m targets under one key (kernel
    B, one launch): out[i, c] = (addend[i, c] + sum_j targets[i, j] *
    key[j, c]) mod q per limb. key: (J, C, kb, n) with kb = k or more (the
    rows read as ``dyadic_mac`` reads b's), targets: (m, J, k, n), both
    below 4q with J <= 4, or reduced; addend (m, C, k, n) or None (the
    c0s of ``decrypt_many``'s phases); out (m, C, k, n), fully reduced.
    The key is read once for every two components of a target; operands
    through their strides as ``dyadic_mac`` reads them."""
    if key.dim() != 4 or targets.dim() != 4 \
            or key.shape[0] != targets.shape[1] \
            or targets.shape[1] > MAC_MAX_TERMS \
            or key.shape[2] < targets.shape[2] \
            or key.shape[3] != targets.shape[3]:
        raise ValueError(f"dyadic_mac_batched: key {tuple(key.shape)} and "
                         f"targets {tuple(targets.shape)} do not fit")
    _check_rows(targets, t, "dyadic_mac_batched targets")
    m, comps = targets.shape[0], key.shape[1]
    shape = (m, comps, t.k, t.n)
    if addend is not None and addend.shape != shape:
        raise ValueError(f"dyadic_mac_batched: addend "
                         f"{tuple(addend.shape)}, expected {shape}")
    if not _kernels.on_cuda(key, targets, t.q,
                            *([] if addend is None else [addend])):
        return dyadic_mac_plain(targets.transpose(0, 1).unsqueeze(2),
                                key_rows_plain(key, t.k).unsqueeze(1), t,
                                addend)
    out = torch.empty(shape, dtype=torch.int64, device=key.device)
    return _launch_mac(out, targets, key, addend, t, key.shape[0], comps, m,
                       [(1, 2), (0, 1)], [(0, 1), (1, 2), None],
                       [(1, 2), (0, 1)], (t.k * t.n, comps * t.k * t.n),
                       "dyadic_mac_batched")


def dyadic_convolve(a: torch.Tensor, b: torch.Tensor,
                    t: RnsNttTables) -> torch.Tensor:
    """The ciphertext-degree convolution of NTT-domain components (kernel
    B, one launch for every output component): out[..., m] = sum_{i + i'
    = m} a[..., i] * b[..., i'] mod q per limb. a (..., s1, k, n) and b
    (..., s2, k, n) with the same leading (batch) axes; b may be a (a
    square: its words read once). The sums fit 128 bits for lazy words
    below 4q where min(s1, s2) <= 4, for reduced words up to 64. Out
    (..., s1 + s2 - 1, k, n), fully reduced."""
    _check_rows(a, t, "dyadic_convolve a")
    _check_rows(b, t, "dyadic_convolve b")
    if a.dim() < 3 or b.dim() != a.dim() or a.shape[:-3] != b.shape[:-3] \
            or min(a.shape[-3], b.shape[-3]) > MAC_MAX_TERMS:
        raise ValueError(f"dyadic_convolve: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} do not fit")
    if not _kernels.on_cuda(a, b, t.q):
        return dyadic_convolve_plain(a, b, t)
    if t.n < 2:
        raise ValueError(f"dyadic_convolve: n = {t.n}: the kernel takes "
                         "n >= 2")
    s1, s2, d = a.shape[-3], b.shape[-3], a.dim()
    square = (a.data_ptr() == b.data_ptr() and a.shape == b.shape
              and a.stride() == b.stride())
    row = t.k * t.n                         # a component's pitch

    def operand(x, name):
        x, (batch, comp) = _in_place(x, [(0, d - 3), (d - 3, d - 2)], t.n,
                                     name)
        if comp not in (0, row):
            x = x.contiguous()
            batch = _run_pitch(x, 0, d - 3)
        return x, batch

    a, a_batch = operand(a, "dyadic_convolve a")
    b, b_batch = (a, a_batch) if square else operand(b, "dyadic_convolve b")
    out = torch.empty(a.shape[:-3] + (s1 + s2 - 1, t.k, t.n),
                      dtype=torch.int64, device=a.device)
    _kernels.launch("troy_dyadic_convolve", out.get_device(), out, a, b,
                    int(square), math.prod(a.shape[:-3]), s1, s2, t.k,
                    t.log_n, a_batch, b_batch, t.q, t.cr_lo, t.cr_hi)
    return out


def rns_dyadic_mul(a: torch.Tensor, b: torch.Tensor,
                   t: RnsNttTables) -> torch.Tensor:
    """Pointwise product mod per-limb q: inputs (..., k, n) (kernel B with
    one term)."""
    return dyadic_mac(a.unsqueeze(0), b.unsqueeze(0), t)
