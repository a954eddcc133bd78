"""The key switch's word arithmetic and the BFV divide-and-round (kernels F, K).

The port of the glue of troy_tpu/evaluator.py ``_switch_key_decompose`` and
``_switch_key_contract`` and of troy_tpu/ops/rns.py
``divide_and_round_q_last``, on csrc/keyswitch.cu:

  * ``keyswitch_digits``: every coefficient of the target reduced into each
    prime of the key switch's working base (Barrett-64), before kernel A's
    NTT;
  * ``divide_round_last``: x (s, k+1, n) in the coefficient domain -> the
    rounded quotient of rows 0..k-1 by the prime of row k, optionally
    added onto an accumulator (the key switch's last step, and with it the
    fold onto (c0, c1));
  * ``ntt_inverse_divide_round``: the key switch's inverse transform and
    that divide in one call (AFi: F's divide in kernel A's last inverse
    pass, csrc/ntt.cu), NTT-form products (s, k+1, n) -> (s, k, n), the
    words of A's inverse then ``divide_round_last``;
  * ``divide_and_round_q_last``: the BFV mod switch, the same divide by the
    level's last prime on its own entry point (kernel K);
  * ``bgv_divide_last``: the BGV divide in the coefficient domain (kernel
    K''), which first subtracts a multiple of the plain modulus that makes
    row k divisible by its prime: the key switch of a coefficient-form BGV
    ciphertext (divisor the special prime) and, in ops/rns.py,
    ``mod_t_and_divide_q_last`` (divisor the level's last prime).

An accumulator is added onto the result's components in one of two
layouts: (a, k, n), onto the first a components, or (g, a, k, n) with a
``group`` size, onto the first a components of every group of ``group``
components, group i taking row i mod g (c0 of each ciphertext of a batch,
or one c0 for all of them).

Each wrapper launches its kernel for tensors on CUDA and runs its plain
version, written on the int64 u64ops twin, for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import ntt as dntt
from . import u64ops as u
from .. import _kernels
from ..interop import to_torch
from .ntt import RnsNttTables

# The kernels keep per-limb constants in a fixed shared-memory block.
MAX_KERNEL_LIMBS = 64


def divide_round_consts(t: RnsNttTables, p: int) -> torch.Tensor:
    """The constants of a divide by p with rounding into the limbs of t, as
    csrc/keyswitch.cu reads them: q (k), the high Barrett words (k),
    floor(p/2) mod q (k), p^-1 mod q (k) and its Shoup words (k), then p and
    floor(p/2). Made once per (tables, p)."""
    key = ("divide_round", p)
    if key not in t._memo:
        half = p >> 1
        qv = t.values
        inv = [pow(p % q, -1, q) for q in qv]
        words = (list(qv) + [((1 << 128) // q) >> 64 for q in qv]
                 + [half % q for q in qv] + inv
                 + [u.shoup_quotient(w, q) for w, q in zip(inv, qv)]
                 + [p, half])
        t._memo[key] = to_torch(np.array(words, dtype=np.uint64), t.device)
    return t._memo[key]


def bgv_divide_consts(t: RnsNttTables, p: int,
                      plain_modulus: int) -> torch.Tensor:
    """The constants of the BGV divide by p in the NTT domain (kernel
    K'-BGV, csrc/divide_round_ntt.cu): ``divide_round_consts(t, p)`` (the
    5k + 2 words K''s finish reads), then the plain modulus tt, the high
    word of floor(2^128 / tt), p^-1 mod tt and its Shoup word, p mod q (k)
    and their Shoup words (k). Made once per (tables, p, tt)."""
    key = ("bgv_divide", p, plain_modulus)
    if key not in t._memo:
        tt = plain_modulus
        inv = pow(p % tt, -1, tt)
        pm = [p % q for q in t.values]
        words = ([tt, ((1 << 128) // tt) >> 64, inv,
                  u.shoup_quotient(inv, tt)] + pm
                 + [u.shoup_quotient(w, q) for w, q in zip(pm, t.values)])
        t._memo[key] = torch.cat([divide_round_consts(t, p), to_torch(
            np.array(words, dtype=np.uint64), t.device)])
    return t._memo[key]


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def keyswitch_digits_plain(x: torch.Tensor, used: RnsNttTables
                           ) -> torch.Tensor:
    """(..., n) words -> (..., used, n): each word mod every used prime."""
    return u.barrett_reduce_64(x.unsqueeze(-2), used.q.reshape(-1, 1),
                               used.cr_hi.reshape(-1, 1))


def add_accumulator_plain(out: torch.Tensor, acc: Optional[torch.Tensor],
                          q: torch.Tensor,
                          group: Optional[int] = None) -> torch.Tensor:
    """out (s, k, n) with acc added in its layout (module docstring); q the
    (k, 1) moduli."""
    if acc is None:
        return out
    s, k, n = out.shape
    acc4, group = (acc.unsqueeze(0), s) if acc.dim() == 3 else (acc, group)
    a = acc4.shape[1]
    grouped = out.reshape(s // group, group, k, n)
    head = u.add_mod(acc4, grouped[:, :a], q).expand(s // group, a, k, n)
    return torch.cat([head, grouped[:, a:]], dim=1).reshape(s, k, n)


def divide_round_last_plain(x: torch.Tensor, consts: torch.Tensor,
                            acc: Optional[torch.Tensor] = None,
                            group: Optional[int] = None) -> torch.Tensor:
    """(s, k+1, n) -> (s, k, n): rows 0..k-1 minus the centred row k, times
    p^-1 (troy_tpu/ops/rns.py divide_and_round_q_last and the tail of
    evaluator._switch_key_contract), plus acc in its layout."""
    k = x.shape[-2] - 1
    q, ratio, half_mod, inv, inv_shoup = (
        consts[i * k:(i + 1) * k].reshape(-1, 1) for i in range(5))
    p, half = (int(v) & u.M64 for v in consts[5 * k:].tolist())
    last = u.add_mod(x[..., k:, :], half, p)               # (s, 1, n)
    temp = u.sub_mod(u.barrett_reduce_64(last, q, ratio), half_mod, q)
    out = u.mul_mod_shoup(u.sub_mod(x[..., :k, :], temp, q), inv, inv_shoup,
                          q)
    return add_accumulator_plain(out, acc, q, group)


def ntt_inverse_divide_round_plain(x: torch.Tensor, rows: RnsNttTables,
                                   consts: torch.Tensor,
                                   acc: Optional[torch.Tensor] = None,
                                   group: Optional[int] = None
                                   ) -> torch.Tensor:
    """The plain version of ``ntt_inverse_divide_round``: A's inverse
    butterfly network over ``rows``, then ``divide_round_last_plain``."""
    return divide_round_last_plain(dntt.ntt_inverse_plain(x, rows), consts,
                                   acc, group)


def bgv_divide_last_plain(x: torch.Tensor, consts: torch.Tensor,
                          acc: Optional[torch.Tensor] = None,
                          group: Optional[int] = None) -> torch.Tensor:
    """The plain version of kernel K'': (s, k+1, n) coefficient form ->
    (s, k, n), (x_j + 2 q_j - (last mod q_j) - (neg_k mod q_j)(p mod q_j))
    p^-1 mod q_j with neg_k = -(last mod tt) p^-1 mod tt and last row k
    (troy_tpu/ops/rns.py:281-304), plus acc in its layout; consts from
    ``bgv_divide_consts``."""
    k = x.shape[-2] - 1
    col = lambda start: consts[start:start + k].reshape(-1, 1)
    q, ratio, inv, inv_shoup = col(0), col(k), col(3 * k), col(4 * k)
    pm, pm_shoup = col(5 * k + 6), col(6 * k + 6)
    tt, tt_hi, inv_t, inv_t_shoup = (
        int(v) & u.M64 for v in consts[5 * k + 2:5 * k + 6].tolist())
    last = x[..., k:, :]                                   # (s, 1, n)
    neg_k = u.mul_mod_shoup(u.neg_mod(u.barrett_reduce_64(last, tt, tt_hi),
                                      tt), inv_t, inv_t_shoup, tt)
    delta = u.mul_mod_shoup(u.barrett_reduce_64(neg_k, q, ratio), pm,
                            pm_shoup, q)
    # below 3 q < 2^63: x < q, and both subtrahends below q
    lazy = x[..., :k, :] + (2 * q - u.barrett_reduce_64(last, q, ratio)
                            - delta)
    out = u.mul_mod_shoup(lazy, inv, inv_shoup, q)
    return add_accumulator_plain(out, acc, q, group)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def keyswitch_digits(x: torch.Tensor, used: RnsNttTables) -> torch.Tensor:
    """The RNS digits of a coefficient-form target reduced into each prime
    of the working base ``used`` (kernel F): (..., n) -> (..., used, n)."""
    if x.shape[-1] != used.n:
        raise ValueError(f"keyswitch_digits: expected (..., {used.n}), got "
                         f"{tuple(x.shape)}")
    if not _kernels.on_cuda(x, used.q):
        return keyswitch_digits_plain(x, used)
    if used.k > MAX_KERNEL_LIMBS:
        raise ValueError(f"keyswitch_digits: {used.k} primes; the kernel "
                         f"takes at most {MAX_KERNEL_LIMBS}")
    x = x.contiguous()
    _kernels.check_operand(x, "keyswitch_digits input")
    out = torch.empty(x.shape[:-1] + (used.k, used.n), dtype=torch.int64,
                      device=x.device)
    _kernels.launch("troy_keyswitch_digits", out.get_device(), out, x,
                    x.numel() // used.n, used.k, used.log_n, used.q,
                    used.cr_hi)
    return out


def accumulator_layout(acc: Optional[torch.Tensor], s: int, k: int, n: int,
                       group: Optional[int], entry: str):
    """(acc as a contiguous (g, a, k, n) tensor or None, a, group, g) for a
    kernel's accumulator arguments; raises if acc does not fit s
    components of (k, n)."""
    if acc is None:
        return None, 0, 1, 1
    if acc.dim() == 3:
        acc, group = acc.unsqueeze(0), s
    if acc.dim() != 4 or group is None or group < 1 or s % group \
            or acc.shape[1] > group or acc.shape[2:] != (k, n) \
            or acc.shape[0] not in (1, s // group):
        raise ValueError(f"{entry}: accumulator {tuple(acc.shape)} with "
                         f"group {group} does not fit ({s}, {k}, {n})")
    return acc.contiguous(), acc.shape[1], group, acc.shape[0]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where the divides (K, F's, K'') would read it off
    the 16-byte alignment of their loads (a view at an odd word offset)."""
    return x.clone() if x.data_ptr() & 15 else x


def _divide(entry: str, x: torch.Tensor, consts: torch.Tensor,
            acc: Optional[torch.Tensor], group: Optional[int]
            ) -> torch.Tensor:
    bgv = entry == "troy_bgv_divide_coeff"
    if x.dim() != 3 or x.shape[1] < 2:
        raise ValueError(f"{entry}: expected (s, k+1, n), got "
                         f"{tuple(x.shape)}")
    s, k, n = x.shape[0], x.shape[1] - 1, x.shape[2]
    if consts.numel() != (7 * k + 6 if bgv else 5 * k + 2):
        raise ValueError(f"{entry}: {consts.numel()} constants for data of "
                         f"{k} limbs")
    operands = [x, consts] + ([acc] if acc is not None else [])
    if not _kernels.on_cuda(*operands):
        accumulator_layout(acc, s, k, n, group, entry)       # the checks
        plain = bgv_divide_last_plain if bgv else divide_round_last_plain
        return plain(x, consts, acc, group)
    if k > MAX_KERNEL_LIMBS or n & (n - 1):
        raise ValueError(f"{entry}: k = {k}, n = {n} not supported")
    if n < 2:
        # the divides move two words a thread, 16 bytes at a time
        raise ValueError(f"{entry}: n = {n}: the kernel takes n >= 2")
    x = _aligned(x.contiguous())
    _kernels.check_operand(x, f"{entry} input")
    acc, a, group, groups = accumulator_layout(acc, s, k, n, group, entry)
    if acc is not None:
        acc = _aligned(acc)
        _kernels.check_operand(acc, f"{entry} accumulator")
    out = torch.empty((s, k, n), dtype=torch.int64, device=x.device)
    _kernels.launch(entry, out.get_device(), out, x, acc, s, a, group, groups,
                    k, n.bit_length() - 1, consts)
    return out


def divide_round_last(x: torch.Tensor, consts: torch.Tensor,
                      acc: Optional[torch.Tensor] = None,
                      group: Optional[int] = None) -> torch.Tensor:
    """The key switch's divide by the special prime with rounding (kernel
    F): x (s, k+1, n) coefficient form, row k the special row; consts from
    ``divide_round_consts``; the result (s, k, n), with acc added in its
    layout (module docstring)."""
    return _divide("troy_keyswitch_divide_round", x, consts, acc, group)


def ntt_inverse_divide_round(x: torch.Tensor, rows: RnsNttTables,
                             consts: torch.Tensor,
                             acc: Optional[torch.Tensor] = None,
                             group: Optional[int] = None) -> torch.Tensor:
    """The key switch's last step in the coefficient domain on A's route
    (AFi: kernel F's divide folded into kernel A's last inverse pass, one
    call, csrc/ntt.cu ``troy_ntt_inverse_keyswitch``): x (s, k+1, n) NTT
    form over ``rows`` (k data limbs, then the special prime of row k) ->
    (s, k, n) coefficient form, the words of ``rns_ntt_inverse(x, rows)``
    then ``divide_round_last(., consts, acc, group)``; consts from
    ``divide_round_consts`` of the k data limbs and that prime. Tables on
    J, a pointwise view, or more than MAX_KERNEL_LIMBS data limbs raise, on
    either device."""
    entry = "ntt_inverse_divide_round"
    if rows.mxu is not None or rows.root_powers.shape[-1] != rows.n:
        raise ValueError(f"{entry}: these tables hold no transform on A "
                         "(kernel J's, or a pointwise view)")
    k, n = rows.k - 1, rows.n
    if x.dim() != 3 or x.shape[1:] != (k + 1, n) or k < 1 \
            or consts.numel() != 5 * k + 2:
        raise ValueError(f"{entry}: x {tuple(x.shape)} and "
                         f"{consts.numel()} constants do not fit {k} limbs "
                         f"and the special prime at n = {n}")
    if k > MAX_KERNEL_LIMBS:
        raise ValueError(f"{entry}: k = {k} limbs; the kernel takes at most "
                         f"{MAX_KERNEL_LIMBS}")
    s = x.shape[0]
    layout = accumulator_layout(acc, s, k, n, group, entry)
    operands = [x, consts, rows.q] + ([acc] if acc is not None else [])
    if not _kernels.on_cuda(*operands):
        return ntt_inverse_divide_round_plain(x, rows, consts, acc, group)
    x = x.contiguous()
    _kernels.check_operand(x, f"{entry} input")
    acc, a, group, groups = layout
    if acc is not None:
        _kernels.check_operand(acc, f"{entry} accumulator")
    scratch = torch.empty_like(x)      # A's first pass (unused below 1024)
    out = torch.empty((s, k, n), dtype=torch.int64, device=x.device)
    _kernels.launch("troy_ntt_inverse_keyswitch", out.get_device(), out, x,
                    scratch, acc, s, a, group, groups, k, rows.log_n,
                    rows.inv_root_powers, rows.inv_root_powers_shoup, rows.q,
                    rows.inv_degree, rows.inv_degree_shoup, consts)
    return out


def bgv_divide_last(x: torch.Tensor, consts: torch.Tensor,
                    acc: Optional[torch.Tensor] = None,
                    group: Optional[int] = None) -> torch.Tensor:
    """The BGV divide by the prime of row k in the coefficient domain
    (kernel K''): x (s, k+1, n) minus a multiple of the plain modulus that
    makes row k divisible by the prime, divided by it; consts from
    ``bgv_divide_consts``; the result (s, k, n), with acc added in its
    layout (module docstring)."""
    return _divide("troy_bgv_divide_coeff", x, consts, acc, group)


def divide_and_round_q_last(x: torch.Tensor,
                            t: RnsNttTables) -> torch.Tensor:
    """BFV mod switch: divide by the last prime of the level's base t with
    rounding, coefficient domain (rns.cpp:805-829; kernel K):
    (s, k, n) -> (s, k-1, n)."""
    if x.dim() != 3 or x.shape[1] != t.k or t.k < 2:
        raise ValueError(f"divide_and_round_q_last: expected (s, {t.k}, n) "
                         f"with at least two limbs, got {tuple(x.shape)}")
    consts = divide_round_consts(t.slice(0, t.k - 1), t.values[-1])
    return _divide("troy_mod_switch_divide_round", x, consts, None, None)


def used_limbs(k: int, key_limbs: int) -> Sequence[int]:
    """The key switch's working base at a level of k limbs: the data limbs
    and the special prime (troy_tpu/evaluator.py:193)."""
    return list(range(k)) + [key_limbs - 1]
