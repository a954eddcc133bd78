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

Ordering contract (shared with the encoder): forward output index j holds
the evaluation at psi^(2*brv(j) + 1); the forward transform takes natural
order to bit-reversed order and the inverse undoes it, n^-1 included.
Lazy outputs: forward in [0, 4q), inverse in [0, 2q). (The JAX package's
MXU path at n >= 2048 returns reduced words even when lazy; every caller
reduces afterwards, so end results are the same words.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import u64ops as u
from .. import _kernels
from ..interop import to_torch
from ..utils.ntt_tables import make_ntt_tables

# One row of n u64 words must fit in a block's shared memory (227 KB).
MAX_KERNEL_N = 16384


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
    # sub-bases and scalar operands made from these tables, by key
    _memo: Dict[tuple, object] = field(default_factory=dict, repr=False)

    @classmethod
    def from_moduli(cls, n: int, moduli: Sequence[int],
                    device) -> "RnsNttTables":
        n = int(n)
        values = tuple(int(q) for q in moduli)
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
            n=n, log_n=n.bit_length() - 1, values=values)

    @property
    def k(self) -> int:
        return len(self.values)

    @property
    def device(self) -> torch.device:
        return self.q.device

    def _sub(self, key: tuple, index) -> "RnsNttTables":
        if key not in self._memo:
            take = lambda a: a[index].contiguous()
            self._memo[key] = RnsNttTables(
                root_powers=take(self.root_powers),
                root_powers_shoup=take(self.root_powers_shoup),
                inv_root_powers=take(self.inv_root_powers),
                inv_root_powers_shoup=take(self.inv_root_powers_shoup),
                q=take(self.q), cr_hi=take(self.cr_hi), cr_lo=take(self.cr_lo),
                inv_degree=take(self.inv_degree),
                inv_degree_shoup=take(self.inv_degree_shoup),
                n=self.n, log_n=self.log_n,
                values=tuple(np.array(self.values, dtype=object)[index]))
        return self._memo[key]

    def select(self, indices: Sequence[int]) -> "RnsNttTables":
        """Sub-base over an arbitrary limb index set, e.g. the key-switch
        working base {q_0..q_{k-1}, p_special}. Made once per index set."""
        indices = tuple(int(i) for i in indices)
        return self._sub(("select", indices), list(indices))

    def slice(self, start: int, stop: int) -> "RnsNttTables":
        """Sub-base over limbs [start, stop)."""
        return self._sub(("slice", start, stop), slice(start, stop))

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
    def from_modulus(cls, n: int, modulus: int, device) -> "NttTables":
        return cls(RnsNttTables.from_moduli(n, (modulus,), device))

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


def dyadic_mac_plain(a: torch.Tensor, b: torch.Tensor,
                     t: RnsNttTables) -> torch.Tensor:
    """sum_j a[j] * b[j] mod q per limb, 128-bit sum then Barrett-128.
    a: (J, ..., k, n) broadcasting against b: (J, ..., k, n)."""
    lo = hi = None
    for j in range(a.shape[0]):
        plo, phi = u.mul128(a[j], b[j])
        lo, hi = (plo, phi) if lo is None else u.add_u128(lo, hi, plo, phi)
    L = lo.dim() - 2
    return u.barrett_reduce_128(lo, hi, _col(t.q, L, 1), _col(t.cr_lo, L, 1),
                                _col(t.cr_hi, L, 1))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check_rows(x: torch.Tensor, t: RnsNttTables, name: str) -> None:
    if x.dim() < 2 or x.shape[-2] != t.k or x.shape[-1] != t.n:
        raise ValueError(f"{name}: expected (..., {t.k}, {t.n}), "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 u64 words, got {x.dtype}")


def _ntt(x: torch.Tensor, t: RnsNttTables, inverse: bool,
         lazy: bool) -> torch.Tensor:
    _check_rows(x, t, "ntt")
    if not _kernels.on_cuda(x, t.q):
        plain = ntt_inverse_plain if inverse else ntt_forward_plain
        return plain(x, t, lazy)
    if t.n > MAX_KERNEL_N:
        raise ValueError(f"ntt: n = {t.n} does not fit one block's shared "
                         f"memory (at most {MAX_KERNEL_N})")
    x = x.contiguous()
    _kernels.check_operand(x, "ntt input")
    out = torch.empty_like(x)
    if inverse:
        roots, shoup = t.inv_root_powers, t.inv_root_powers_shoup
    else:
        roots, shoup = t.root_powers, t.root_powers_shoup
    _kernels.launch("troy_ntt", out, x, x.numel() // t.n, t.log_n, t.k,
                    roots, shoup, t.q, t.inv_degree, t.inv_degree_shoup,
                    int(inverse), int(lazy))
    return out


def rns_ntt_forward(x: torch.Tensor, t: RnsNttTables,
                    lazy: bool = False) -> torch.Tensor:
    """Forward NTT of every limb: (..., k, n) -> (..., k, n). Input words
    below 4q; output in [0, q), or [0, 4q) if lazy."""
    return _ntt(x, t, inverse=False, lazy=lazy)


def rns_ntt_inverse(x: torch.Tensor, t: RnsNttTables,
                    lazy: bool = False) -> torch.Tensor:
    """Inverse NTT of every limb, n^-1 included. Input words below 2q;
    output in [0, q), or [0, 2q) if lazy."""
    return _ntt(x, t, inverse=True, lazy=lazy)


def ntt_forward(x: torch.Tensor, t: NttTables,
                lazy: bool = False) -> torch.Tensor:
    """Single-modulus forward NTT over the last axis (kernel A, k = 1)."""
    return rns_ntt_forward(x.unsqueeze(-2), t.rns, lazy).squeeze(-2)


def ntt_inverse(x: torch.Tensor, t: NttTables,
                lazy: bool = False) -> torch.Tensor:
    """Single-modulus inverse NTT over the last axis (kernel A, k = 1)."""
    return rns_ntt_inverse(x.unsqueeze(-2), t.rns, lazy).squeeze(-2)


def ntt_forward_limb(x: torch.Tensor, t: RnsNttTables, i: int,
                     lazy: bool = False) -> torch.Tensor:
    """Forward NTT of limb i of an RNS base: (..., n) -> (..., n)."""
    return ntt_forward(x, t.limb(i), lazy)


def ntt_inverse_limb(x: torch.Tensor, t: RnsNttTables, i: int,
                     lazy: bool = False) -> torch.Tensor:
    """Inverse NTT of limb i of an RNS base: (..., n) -> (..., n)."""
    return ntt_inverse(x, t.limb(i), lazy)


def dyadic_mac(a: torch.Tensor, b: torch.Tensor,
               t: RnsNttTables) -> torch.Tensor:
    """out = sum_j a[j] * b[j] mod q per limb (kernel B).

    a: (J, Ra, n) and b: (J, ..., Ra, n), whose rows are (..., k, n)
    stacks; a broadcasts over b's extra leading axes (the two key
    components of the key switch share one decomposed target). The sum must
    fit 128 bits: any words for one term, lazy words below 4q (< 2^63) for
    up to four, reduced words for up to 64. Output (..., Ra, n), fully
    reduced."""
    if a.shape[0] != b.shape[0] or a.shape[0] < 1 or a.shape[0] > 64:
        raise ValueError(f"dyadic_mac: terms {a.shape[0]} vs {b.shape[0]}")
    if a.shape[1:] != b.shape[b.dim() - a.dim() + 1:]:
        raise ValueError(f"dyadic_mac: {tuple(a.shape)} does not broadcast "
                         f"over {tuple(b.shape)}")
    _check_rows(a, t, "dyadic_mac a")
    if not _kernels.on_cuda(a, b, t.q):
        extra = b.dim() - a.dim()
        a_b = a.reshape(a.shape[:1] + (1,) * extra + a.shape[1:])
        return dyadic_mac_plain(a_b, b, t)
    a = a.contiguous()
    b = b.contiguous()
    _kernels.check_operand(a, "dyadic_mac a")
    _kernels.check_operand(b, "dyadic_mac b")
    terms = a.shape[0]
    ra = a[0].numel() // t.n
    rb = b[0].numel() // t.n
    out = torch.empty(b.shape[1:], dtype=torch.int64, device=b.device)
    _kernels.launch("troy_dyadic_mac", out, a, b, terms, ra, rb, t.log_n,
                    t.k, t.q, t.cr_lo, t.cr_hi)
    return out


def rns_dyadic_mul(a: torch.Tensor, b: torch.Tensor,
                   t: RnsNttTables) -> torch.Tensor:
    """Pointwise product mod per-limb q: inputs (..., k, n) (kernel B with
    one term)."""
    return dyadic_mac(a.unsqueeze(0), b.unsqueeze(0), t)
