"""Evaluator: add, sub, negate, multiply, square, relinearize, Galois
rotations, the mod switch, (CKKS) the rescale, and the plaintext-operand
ops.

The port of troy_tpu/evaluator.py, BFV, CKKS and BGV branches. The JAX
package traces each operation into one XLA program; here each step is a
kernel launch over the whole batch of polynomials and limbs it touches:

  * BFV multiply lifts both operands from q to Bsk (kernel E; square lifts
    its one operand once), transforms the rows in q and in Bsk together
    (kernel A), convolves them in the NTT domain (kernel B), then
    transforms back (A) and scales by t, floors by Q and converts Bsk -> q
    (E); CKKS and BGV ciphertexts are in NTT form, so their multiply and
    square are the convolution alone (B), BGV's with the product of the
    correction factors;
  * a key switch (relinearize, Galois, apply_keyswitching) reduces the
    target into RNS digits (kernel F; an NTT-form target is first
    inverse-transformed by A), transforms them (one A launch over
    k x (k+1) limbs), takes the 128-bit inner product with the key (one B
    launch for both key components) and
    divides by the special prime with rounding, adding the result onto the
    ciphertext: in the coefficient domain in A's inverse (AFi: F's divide
    in A's last pass; an inverse, then F, on J's route), or in the
    NTT domain (A on the special row, K', A, K'; for BGV the t-corrected
    temps of K'-BGV);
  * ``apply_galois`` permutes both components (kernel M: signed in the
    coefficient domain, a plain gather in the NTT domain) before the key
    switch of c1; a coefficient-form BGV key switch divides by the special
    prime in the coefficient domain with the t-corrected K''; the hoisted
    ``apply_galois_many`` decomposes c1 once and contracts it with every
    element's pre-permuted key in one B launch, then lands each
    automorphism with one batched M gather; the LWE ops shift, extract and
    assemble on kernel N1, and the pack tree folds pairs on N2 and then
    key-switches every pair in one batched fold (M, AF, B, A, the divide)
    per layer, as does each step of the field trace;
    BFV's ``mod_switch_to_next`` divides by the level's last
    prime (kernel K), CKKS's drops it, BGV's subtracts a multiple of t and
    divides in the NTT domain (A, K'-BGV) and carries the correction factor
    times q_last^-1 mod t, and ``rescale_to_next`` divides by it in the NTT
    domain (K'); BGV add and sub of unequal correction factors balance
    and add in one kernel-D launch (e1 a +- e2 b);
  * a mod-t plaintext enters BFV's add_plain through the plain embedding
    (kernel G) and every multiply_plain, and BGV's add_plain, through the
    plain lift (kernel G') and A; the product with a plaintext is one
    B launch over every component.

The ops run on the CPU too, on the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .context import ContextData, HeContext
from .he_types import (Ciphertext, GaloisKeys, KSwitchKeys, LWECiphertext,
                       Plaintext, RelinKeys)
from .params import SchemeType
from . import rlwe
from .ops import galois as dgalois
from .ops import keyswitch as dks
from .ops import ntt as dntt
from .ops import poly as dpoly
from .ops import rns as drns
from .ops import tiles as dtiles
from .utils import galois as galois_util
from .utils import numth
from .utils import profiling

def _scales_close(a: float, b: float) -> bool:
    return abs(a - b) <= max(abs(a), abs(b)) * 1e-9


def _dyadic_convolution(a: torch.Tensor, b: torch.Tensor,
                        tables: dntt.RnsNttTables) -> torch.Tensor:
    """Ciphertext-degree convolution of NTT-domain components
    (kernelutils.cu:89-115): out[m] = sum_{i+j=m} a[i] * b[j], every output
    component in one kernel-B launch with its terms summed in 128 bits.
    a: (..., s1, k, n), b: (..., s2, k, n) with the same leading (batch)
    axes, inputs lazy below 4q; b may be a (a square)."""
    return dntt.dyadic_convolve(a, b, tables)


def _bfv_multiply(d1: torch.Tensor, d2: Optional[torch.Tensor],
                  cd: ContextData) -> torch.Tensor:
    """BEHZ RNS multiplication (evaluator_cuda.cu:283-382): lift to Bsk,
    dyadic-convolve in q and Bsk as one base, scale by t, fast-floor by Q,
    convert Bsk -> q. d2 None squares d1 (evaluator_cuda.cu:525-601
    bfvSquare): one lift of its components instead of two; the same words
    as the JAX package's ``_bfv_square``, since the convolution reduces
    fully."""
    tool = cd.rns
    s1 = d1.shape[0]
    with profiling.span("bfv_lift_ntt"):
        both = d1 if d2 is None else torch.cat([d1, d2])  # every component
        rows_ntt = _bfv_lift_ntt(both, cd)
    b = rows_ntt if d2 is None else rows_ntt[s1:]
    with profiling.span("bfv_convolve"):
        prod = _dyadic_convolution(rows_ntt[:s1], b, tool.q_bsk)
    with profiling.span("bfv_tail"):
        return drns.behz_tail(dntt.rns_ntt_inverse(prod, tool.q_bsk), tool)


def _bfv_lift_ntt(d: torch.Tensor, cd: ContextData) -> torch.Tensor:
    """The first half of the BFV multiply for any batch of coefficient-form
    components (..., k, n): the BEHZ lift to Bsk (one E launch) and the lazy
    forward transform of the rows in q u Bsk (one A launch), (..., k +
    |Bsk|, n)."""
    rows = torch.cat([d, drns.behz_lift(d, cd.rns)], dim=-2)
    return dntt.rns_ntt_forward(rows, cd.rns.q_bsk, lazy=True)


def _pair_grid_multiply(a: torch.Tensor, w: torch.Tensor,
                        cd: ContextData) -> torch.Tensor:
    """The products of every pair of an X x Yc ciphertext grid, as the JAX
    package vmaps ``_bfv_multiply`` or ``_ntt_form_multiply`` over it
    (troy_tpu/app/linear.py:133): a (X, s1, R, n), w (Yc, s2, R, n) ->
    (X, Yc, s1 + s2 - 1, k, n). CKKS and BGV: NTT-form tiles over q, the
    convolution alone (kernel P2). BFV: tiles already through
    ``_bfv_lift_ntt`` (R = k + |Bsk|), so each tile is lifted and
    transformed once for the whole grid, not once per pair; then P2 and
    one inverse A over every product (on A's route one call: P2 in A's
    first inverse pass, AP2i) and one E tail: the tail runs per product,
    so the words are ``_bfv_multiply``'s."""
    if cd.scheme != SchemeType.bfv:
        return dtiles.tile_pair_convolve(a, w, cd.ntt)
    tool = cd.rns
    if dntt.on_a_route(tool.q_bsk):
        coeff = dntt.rns_ntt_inverse_pair_convolve(a, w, tool.q_bsk)
    else:
        coeff = dntt.rns_ntt_inverse(
            dtiles.tile_pair_convolve(a, w, tool.q_bsk), tool.q_bsk)
    return drns.behz_tail(coeff, tool)


def _used_tables(cd: ContextData, key_cd: ContextData) -> dntt.RnsNttTables:
    """The key switch's working base: the level's primes and the special
    prime."""
    return key_cd.ntt.select(dks.used_limbs(cd.limbs, key_cd.limbs))


def _key_rows(key: torch.Tensor, k: int, kf: int) -> torch.Tensor:
    """A switching key (decomp, ..., kf, n) restricted to the digits and
    limbs of a level of k limbs; at the first level, the whole key."""
    if k == kf - 1:
        return key[:k]
    return torch.cat([key[:k, ..., :k, :], key[:k, ..., -1:, :]], dim=-2)


def _switch_key_decompose(target: torch.Tensor, cd: ContextData,
                          key_cd: ContextData, ntt_form: bool,
                          limbs: Optional[range] = None) -> torch.Tensor:
    """Stage 1 of the key switch (troy_tpu/evaluator.py:179): the RNS digits
    of targets (..., k, n) in every used prime, transformed: (..., k, used,
    n), fully reduced. On A's route the digits are folded into A's first
    pass (``rns_ntt_forward_digits``: one A call for the whole batch); on
    kernel J, one launch of F's digits and J's transform. ``limbs``: the
    target holds only these limbs of the level (a shard of the limb axis,
    parallel/sharding.py), and only their digits are made.

    An NTT-form target's digits are its inverse transform (A) reduced into
    every used prime and transformed again, k x (k+1) rows: the JAX
    package's diagonal shortcut (which reuses the k diagonal rows) gives the
    same words and is not taken.

    On kernel J the digit rows go through the transform grouped by the
    width of their data prime, with that width as the words' bound
    (troy_tpu/evaluator.py:242-257): row j's words are below q_j, so a
    40-bit row lifted into a 60-bit key prime runs 8 x 5 plane pairs, not
    8 x 8. The words do not change."""
    used = _used_tables(cd, key_cd)
    own = cd.ntt if limbs is None else cd.ntt.slice(limbs.start, limbs.stop)
    limbs = range(cd.limbs) if limbs is None else limbs
    if ntt_form:
        target = dntt.rns_ntt_inverse(target, own)
    if used.mxu is None:
        return dntt.rns_ntt_forward_digits(target, used)
    digits = dks.keyswitch_digits(target, used)
    groups = {}
    for j, q in enumerate(cd.coeff_values[limbs.start:limbs.stop]):
        groups.setdefault(q.bit_length(), []).append(j)
    if len(groups) == 1:
        return dntt.rns_ntt_forward(digits, used, x_bound_bits=next(
            iter(groups)))
    out = torch.empty_like(digits)
    for bits, rows in sorted(groups.items()):
        out[..., rows, :, :] = dntt.rns_ntt_forward(
            digits[..., rows, :, :], used, x_bound_bits=bits)
    return out


def _switch_key_inner_product(t_hat: torch.Tensor, key: torch.Tensor,
                              cd: ContextData,
                              key_cd: ContextData) -> torch.Tensor:
    """The 128-bit inner product of the digits with the key over the
    working base (troy_tpu/evaluator.py:262), one kernel-B launch, in the
    three shapes of ``_switch_key_contract``: (2, k + 1, n), or (m, 2,
    k + 1, n) for the hoisted keys and the batched fold, fully reduced.
    Below the first level B reads the key's rows of the level's primes and
    its special row in place (ops/ntt.py ``dyadic_mac``)."""
    k = cd.limbs
    used = _used_tables(cd, key_cd)
    if t_hat.dim() == 4:
        return dntt.dyadic_mac_batched(key[:k], t_hat, used)
    return dntt.dyadic_mac(t_hat, key if key.dim() == 5 else key[:k], used)


def _switch_key_contract(t_hat: torch.Tensor, key: torch.Tensor,
                         cd: ContextData, key_cd: ContextData,
                         ntt_form: bool,
                         acc: Optional[torch.Tensor] = None,
                         group: Optional[int] = None) -> torch.Tensor:
    """Stage 2 (troy_tpu/evaluator.py:290): the 128-bit inner product with
    the key (one B launch) and the divide by the special prime, the result
    in the TARGET's domain (``ntt_form``), with acc added in the layout of
    ops/keyswitch.py. Three shapes:

      * t_hat (k, used, n), key (decomp, 2, kf, n) -> (2, k, n);
      * t_hat (k, used, n), keys (k, m, 2, used, n), stacked and
        restricted to the level (the hoisted path) -> (m, 2, k, n);
      * t_hat (m, k, used, n), key (decomp, 2, kf, n) (the batched fold)
        -> (m, 2, k, n).

    The divide is ``_divide_by_special``'s, in the target's domain. The
    JAX package picks the domain by scheme, which is wrong for an NTT-form
    BFV or a coefficient-form BGV target."""
    prods = _switch_key_inner_product(t_hat, key, cd, key_cd)
    lead = prods.shape[:-2]
    out = _divide_by_special(prods.reshape((-1,) + prods.shape[-2:]), cd,
                             key_cd, ntt_form, acc, group)
    return out.reshape(lead + out.shape[-2:])


def _divide_by_special(prods: torch.Tensor, cd: ContextData,
                       key_cd: ContextData, ntt_form: bool,
                       acc: Optional[torch.Tensor] = None,
                       group: Optional[int] = None,
                       limbs: Optional[range] = None,
                       forward: Callable = dntt.rns_ntt_forward,
                       inverse: Callable = dntt.rns_ntt_inverse
                       ) -> torch.Tensor:
    """The end of stage 2: the inner products prods (s, k_o + 1, n), NTT
    form, rows over the output limbs then the special prime, divided by the
    special prime -> (s, k_o, n) in the TARGET's domain (``ntt_form``),
    with acc added in the layout of ops/keyswitch.py. CKKS and BGV in the
    NTT domain: A on the special row, then on A's route one A forward with
    K''s temps and finish in its passes (BGV: the t-corrected temps of
    K'-BGV), on J's route K', J, K'; in the coefficient domain, BFV on
    A's route one call of AFi (F's rounding divide in A's last inverse
    pass), otherwise an inverse (A or J) of the products, then F's
    rounding divide (BFV) or the t-corrected one of K'' (BGV). ``limbs``:
    the output limbs, a run of the level's (a shard of the limb axis,
    parallel/sharding.py), all of them by default.
    ``forward`` and ``inverse``: the transforms, called as A's; a
    coefficient-sharded mesh passes kernel J's (parallel/sharding.py)."""
    k = cd.limbs
    used = _used_tables(cd, key_cd)
    p = key_cd.coeff_values[-1]
    bgv = cd.scheme == SchemeType.bgv
    if limbs is None:
        tables, rows = cd.ntt, used
    else:
        tables = cd.ntt.slice(limbs.start, limbs.stop)
        rows = used.select(list(limbs) + [k])
    if not bgv:
        consts = dks.divide_round_consts(tables, p)
    elif limbs is None:
        consts = cd.bgv_keyswitch_consts
    else:
        consts = dks.bgv_divide_consts(tables, p, int(cd.plain_modulus))
    if ntt_form:
        return drns.divide_round_last_ntt(
            prods, tables, used.slice(k, k + 1), consts, acc,
            drns.BGV_KEYSWITCH if bgv else drns.KEYSWITCH, group, forward,
            inverse)
    if not bgv and used.mxu is None and inverse is dntt.rns_ntt_inverse:
        return dks.ntt_inverse_divide_round(prods, rows, consts, acc, group)
    divide = dks.bgv_divide_last if bgv else dks.divide_round_last
    return divide(inverse(prods, rows), consts, acc, group)


def _switch_key_core(target: torch.Tensor, key: torch.Tensor,
                     cd: ContextData, key_cd: ContextData,
                     acc: Optional[torch.Tensor] = None,
                     ntt_form: bool = False, group: Optional[int] = None,
                     caller: str = "switch_key") -> torch.Tensor:
    """The key switch (evaluator_cuda.cu:1163-1362) of a target (k, n) under
    key (decomp, 2, key_limbs, n), NTT form: (2, k, n) in the target's
    domain, with acc (a, k, n), a <= 2, added onto its first a
    components; or of the batched shapes of ``_switch_key_contract``
    (acc in its layout, ``group``), (m, 2, k, n). Every key switch of the
    evaluator runs here, in one ``keyswitch`` span, counted under
    ``caller`` with the polynomials switched (``keyswitch_counts``)."""
    with profiling.span("keyswitch"):
        with profiling.span("keyswitch_decompose"):
            t_hat = _switch_key_decompose(target, cd, key_cd, ntt_form)
        with profiling.span("keyswitch_contract"):
            out = _switch_key_contract(t_hat, key, cd, key_cd, ntt_form,
                                       acc, group)
    if profiling.active:
        profiling.count("keyswitch", caller,
                        out.shape[0] if out.dim() == 4 else 1)
    return out


def keyswitch_counts() -> Dict[str, Dict[str, int]]:
    """The key switches counted while recording was on
    (``utils/profiling.py``), by caller (``relinearize``, ``galois_fold``,
    ``apply_galois``, ``apply_galois_many``, ``apply_keyswitching``, ...):
    calls and polynomials switched, since the recorder's last ``clear()``.
    A batched fold of m ciphertexts is one call of m polynomials."""
    return {k: {"calls": c, "polys": p}
            for k, (c, p) in profiling.counts("keyswitch").items()}


def _relinearize_core(data: torch.Tensor, keys, cd: ContextData,
                      key_cd: ContextData, ntt_form: bool) -> torch.Tensor:
    """Relinearization (size s -> 2): every c_p (p >= 2) key-switched and
    folded into (c0, c1) (evaluator_cuda.cu:703)."""
    c01 = data[:2]
    for i, key in enumerate(keys):
        c01 = _switch_key_core(data[2 + i], key, cd, key_cd, acc=c01,
                               ntt_form=ntt_form, caller="relinearize")
    return c01


def _apply_galois_core(data: torch.Tensor, elt: int, key: torch.Tensor,
                       cd: ContextData, key_cd: ContextData,
                       ntt_form: bool) -> torch.Tensor:
    """Galois of one ciphertext (troy_tpu/evaluator.py:417, :430): both
    components permuted in one launch of kernel M (signed in the
    coefficient domain, a plain gather in the NTT domain), then c1
    key-switched in that domain and the result added onto the permuted
    c0."""
    if ntt_form:
        permuted = dgalois.permute(
            data, dgalois.ntt_table(cd.n, elt, cd.device))
    else:
        permuted = dgalois.permute(
            data, dgalois.coeff_table(cd.n, elt, cd.device), cd.ntt)
    return _switch_key_core(permuted[1], key, cd, key_cd, acc=permuted[:1],
                            ntt_form=ntt_form, caller="apply_galois")


def _batched_galois_fold(data: torch.Tensor, elt: int, key: torch.Tensor,
                         cd: ContextData, key_cd: ContextData,
                         ntt_form: bool) -> torch.Tensor:
    """One automorphism and key switch over a batch of size-2 ciphertexts
    (troy_tpu/evaluator.py:442): data (m, 2, k, n) -> (m, 2, k, n). One M
    launch permutes every component and writes the c0s and the c1s as two
    stacks; the key switch of the m c1s is one call each of AF (F's digits
    in A's first pass; on J, F and J), B, A and the divide (F or K'' in
    the coefficient domain; K' twice and A in the NTT domain), which adds
    the permuted c0s. One ``galois_fold`` span."""
    with profiling.span("galois_fold"):
        tables = dgalois.batched_tables(cd.n, (elt,), cd.device,
                                        not ntt_form)
        permuted = dgalois.permute_batched(data, tables, cd.ntt,
                                           comps_first=True)  # (2, m, k, n)
        return _switch_key_core(permuted[1], key, cd, key_cd,
                                acc=permuted[0].unsqueeze(1),
                                ntt_form=ntt_form, group=2,
                                caller="galois_fold")


def _hoisted_galois_core(data: torch.Tensor, elts: Sequence[int],
                         keys_pp: torch.Tensor, cd: ContextData,
                         key_cd: ContextData,
                         ntt_form: bool) -> torch.Tensor:
    """Hoisted multi-automorphism of one ciphertext (troy_tpu/evaluator.py
    :463 _hoisted_galois_core): the digits of c1 decomposed and transformed
    once (AF); the keys, pre-permuted by each element's inverse
    automorphism and stacked (k, m, 2, used, n), contracted in one B
    launch; one divide over the m x 2 components that adds the un-permuted
    c0 onto each; one batched M gather that lands every element's
    automorphism. Valid because the inner product is elementwise in the
    evaluation index and the divide commutes with the automorphism up to
    rounding representatives: NOT word-equal to the sequential path (the
    words of the JAX package's hoisted path instead); decryption agrees.
    data (2, k, n) -> (m, 2, k, n)."""
    out = _switch_key_core(data[1], keys_pp, cd, key_cd,
                           acc=data[:1].unsqueeze(0), ntt_form=ntt_form,
                           group=2, caller="apply_galois_many")
    tables = dgalois.batched_tables(cd.n, tuple(elts), cd.device,
                                    not ntt_form)
    return dgalois.permute_batched(out, tables, cd.ntt)


def _balance_correction_factors(f1: int, f2: int, t: int
                                ) -> Tuple[int, int, int]:
    """BGV correction-factor balancing (evaluator_cuda.cu:53-70): a small
    centred pair (e1, e2) with e1 f1 = e2 f2 mod t from the extended Euclid
    walk on (t, f2/f1); returns (new factor, e1, e2). Host logic, copied
    from troy_tpu/evaluator.py:804-833."""
    if f1 == f2:
        return f1, 1, 1
    ratio = f2 * numth.invert_mod(f1 % t, t) % t

    def cost(x):
        x %= t
        return min(x, t - x)

    best_e1, best_e2 = ratio, 1
    best = cost(ratio) + cost(1)
    prev_r, r = t, ratio
    prev_s, s = 0, 1
    while r != 0:
        q = prev_r // r
        prev_r, r = r, prev_r - q * r
        prev_s, s = s, prev_s - q * s
        if r == 0:
            break
        e1, e2 = r % t, s % t
        if numth.gcd(e2, t) == 1:
            c = cost(e1) + cost(e2)
            if c < best:
                best, best_e1, best_e2 = c, e1, e2
    return best_e1 * f1 % t, best_e1, best_e2


def _plain_to_ntt(m: torch.Tensor, cd: ContextData,
                  correction_factor: int = 1) -> torch.Tensor:
    """A mod-t plaintext (..., n) lifted centred to the level's base (times
    cf mod t first when cf != 1) and transformed: (..., k, n)
    (troy_tpu/evaluator.py:708 _plain_to_ntt). On A's route one call (the
    lift in A's first pass, AGp); on J's kernel G', then J."""
    return dpoly.plain_lift_ntt(m, cd.ntt, int(cd.plain_modulus),
                                cd.plain_upper_half_threshold,
                                cd.total_coeff_modulus, correction_factor)


def _multiply_plain_ntt(data: torch.Tensor, plain: torch.Tensor,
                        cd: ContextData) -> torch.Tensor:
    """Every component (s, k, n) times one NTT-form plaintext (k, n), one
    kernel-B launch (troy_tpu/evaluator.py:717 _multiply_plain_ntt)."""
    return dntt.dyadic_mac(plain.unsqueeze(0), data.unsqueeze(0), cd.ntt)


def _pad(m: torch.Tensor, n: int) -> torch.Tensor:
    """A coefficient-form plaintext zero-padded to n coefficients (itself,
    not a copy, when it has n)."""
    if m.shape[-1] > n:
        raise ValueError(f"plaintext has {m.shape[-1]} coefficients > n={n}")
    if m.shape[-1] == n:
        return m
    return torch.nn.functional.pad(m, (0, n - m.shape[-1]))


class Evaluator:
    """(evaluator.h:72): BFV (coefficient-form ciphertexts), CKKS
    (NTT-form ciphertexts with a scale) and BGV (NTT-form ciphertexts with
    a correction factor; the Galois ops, the negacyclic shift and the LWE
    ops also take BGV in coefficient form)."""

    # Bound on cached pre-permuted switching keys: each entry holds one
    # key's worth of device memory (7.9 MB at n = 16384 and 6 primes).
    PP_KEY_CACHE_MAX = 32
    # apply_galois_many hoists from this many elements; below, it runs
    # apply_galois per element. Measured on an H100 80GB HBM3 at 700 W
    # (n = 16384, q = {60,40,40,40,40,60}, chip_smoke.py phase 18), hoisted
    # over sequential at m = 1, 2, 4, 8, 16: BFV 1.225, 0.633, 0.351,
    # 0.185, 0.103; CKKS 1.222, 0.571, 0.277, 0.165, 0.091; BGV 1.037,
    # 0.321, 0.316, 0.205, 0.102.
    HOIST_MIN_M = 2
    # Bound on cached stacks of them, one per (keys, elements, level) of
    # an apply_galois_many call; a stack of m keys is m keys' worth.
    PP_STACK_CACHE_MAX = 4

    def __init__(self, context: HeContext):
        self.context = context
        self._pp_keys: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._pp_stacks: "OrderedDict[tuple, tuple]" = OrderedDict()

    def _cd(self, ct: Ciphertext) -> ContextData:
        return self.context.get_context_data(ct.level)

    def _ntt_scheme(self, ct: Ciphertext, what: str) -> ContextData:
        """The level of a CKKS or BGV ciphertext, which must be in NTT form
        for ``what``."""
        cd = self._cd(ct)
        if cd.scheme != SchemeType.bfv and not ct.is_ntt_form:
            raise ValueError(f"{cd.scheme.name} {what} expects NTT form")
        return cd

    def _galois_level(self, ct: Ciphertext, what: str) -> ContextData:
        """The level of a ciphertext for a Galois or LWE op: BFV and BGV in
        either form (the key switch divides in the ciphertext's domain),
        CKKS in NTT form."""
        cd = self._cd(ct)
        if cd.scheme == SchemeType.ckks and not ct.is_ntt_form:
            raise ValueError(f"CKKS {what} expects NTT form")
        return cd

    def _ckks(self, what: str) -> None:
        if self.context.scheme != SchemeType.ckks:
            raise ValueError(f"{what} is CKKS-only")

    def _batching(self, what: str) -> None:
        if self.context.scheme == SchemeType.ckks:
            raise ValueError(f"{what} is BFV/BGV-only")

    @staticmethod
    def _check_same(a: Ciphertext, b: Ciphertext) -> None:
        if a.level != b.level:
            raise ValueError("ciphertexts are at different chain levels")
        if a.is_ntt_form != b.is_ntt_form:
            raise ValueError("NTT form mismatch")

    def negate(self, ct: Ciphertext) -> Ciphertext:
        return ct.replace(data=dpoly.rns_neg(ct.data, self._cd(ct).ntt))

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._add_sub(a, b, subtract=False)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._add_sub(a, b, subtract=True)

    def _add_sub(self, a: Ciphertext, b: Ciphertext,
                 subtract: bool) -> Ciphertext:
        """BGV first brings both to one correction factor: e1 a and e2 b,
        e1 cf_a = e2 cf_b mod t (troy_tpu/evaluator.py:874-883)."""
        self._check_same(a, b)
        cd = self._cd(a)
        if cd.scheme == SchemeType.ckks and not _scales_close(a.scale,
                                                              b.scale):
            raise ValueError(f"CKKS scales mismatch in "
                             f"{'sub' if subtract else 'add'}")
        t = cd.ntt
        da, db, cf = a.data, b.data, a.correction_factor
        s = min(a.size, b.size)
        if cd.scheme == SchemeType.bgv and cf != b.correction_factor:
            # e1 a +- e2 b in one kernel-D launch; a longer operand's own
            # components times e1, or +-e2
            cf, e1, e2 = _balance_correction_factors(
                cf, b.correction_factor, int(cd.plain_modulus))
            parts = [dpoly.balanced_add(da[:s], db[:s], e1, e2, t, subtract)]
            if a.size > s:
                parts.append(dpoly.rns_broadcast_scalar_mul(da[s:], e1, t))
            elif b.size > s:
                parts.append(dpoly.rns_broadcast_scalar_mul(
                    db[s:], -e2 if subtract else e2, t))
        else:
            op = dpoly.rns_sub if subtract else dpoly.rns_add
            parts = [op(da[:s], db[:s], t)]
            if a.size > s:
                parts.append(da[s:])
            elif b.size > s:
                parts.append(dpoly.rns_neg(db[s:], t) if subtract
                             else db[s:])
        data = parts[0] if len(parts) == 1 else torch.cat(parts)
        return a.replace(data=data, correction_factor=cf)

    def add_many(self, cts: Sequence[Ciphertext]) -> Ciphertext:
        acc = cts[0]
        for c in cts[1:]:
            acc = self.add(acc, c)
        return acc

    @profiling.spanned("multiply")
    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_same(a, b)
        return self._multiply(a, b)

    def _multiply(self, a: Ciphertext, b: Optional[Ciphertext]
                  ) -> Ciphertext:
        """a times b, or a squared when b is None."""
        cd = self._ntt_scheme(a, "multiply")
        if cd.scheme == SchemeType.bfv:
            if a.is_ntt_form:
                raise ValueError("BFV multiply expects coefficient form")
            return a.replace(data=_bfv_multiply(
                a.data, None if b is None else b.data, cd))
        b = a if b is None else b
        # the NTT-domain convolution (evaluator_cuda.cu:384-432, :435+)
        data = _dyadic_convolution(a.data, b.data, cd.ntt)
        if cd.scheme == SchemeType.ckks:
            return a.replace(data=data, scale=a.scale * b.scale)
        return a.replace(data=data, correction_factor=(
            a.correction_factor * b.correction_factor
            % int(cd.plain_modulus)))

    def square(self, a: Ciphertext) -> Ciphertext:
        """BFV: the dedicated square, one BEHZ lift of a's components
        (multiply(a, a) lifts them twice). CKKS and BGV: the convolution
        of a with itself, whose cross term a0 a1 + a1 a0 is one two-term
        kernel-B launch (the same fully reduced words as the JAX package's
        doubled product)."""
        return self._multiply(a, None)

    def multiply_many(self, cts: Sequence[Ciphertext],
                      relin_keys: RelinKeys) -> Ciphertext:
        """Balanced product tree, relinearizing each product
        (evaluator.h multiplyMany)."""
        layer = list(cts)
        while len(layer) > 1:
            nxt = [self.relinearize(self.multiply(layer[i], layer[i + 1]),
                                    relin_keys)
                   for i in range(0, len(layer) - 1, 2)]
            if len(layer) % 2:
                nxt.append(layer[-1])
            layer = nxt
        return layer[0]

    def exponentiate(self, ct: Ciphertext, power: int,
                     relin_keys: RelinKeys) -> Ciphertext:
        if power < 1:
            raise ValueError("power must be >= 1")
        return self.multiply_many([ct] * power, relin_keys)

    def apply_keyswitching(self, ct: Ciphertext,
                           kswitch_keys: KSwitchKeys) -> Ciphertext:
        """Switch a size-2 ciphertext to the key of ``kswitch_keys.keys[1]``
        (evaluator_cuda.cuh applyKeySwitching): c1 key-switched, the result
        added onto c0."""
        if ct.size != 2:
            raise ValueError("key switching expects size-2 ciphertexts")
        cd = self._ntt_scheme(ct, "apply_keyswitching")
        data = _switch_key_core(ct.data[1], kswitch_keys.keys[1], cd,
                                self.context.key_context_data,
                                acc=ct.data[:1], ntt_form=ct.is_ntt_form,
                                caller="apply_keyswitching")
        return ct.replace(data=data)

    @profiling.spanned("relinearize")
    def relinearize(self, ct: Ciphertext,
                    relin_keys: RelinKeys) -> Ciphertext:
        """Reduce the ciphertext size back to 2 (evaluator_cuda.cu:703)."""
        if ct.size == 2:
            return ct
        cd = self._ntt_scheme(ct, "relinearize")
        keys = tuple(relin_keys.keys[p] for p in range(2, ct.size))
        data = _relinearize_core(ct.data, keys, cd,
                                 self.context.key_context_data,
                                 ct.is_ntt_form)
        return ct.replace(data=data)

    # ---- modulus switching (evaluator_cuda.cu:749+) ----
    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        """Drop the level's last prime (troy_tpu/evaluator.py:998): BFV
        divides by it with rounding, CKKS drops the limb (a view), BGV
        subtracts a multiple of t and divides by it in the NTT domain, the
        correction factor times q_last^-1 mod t."""
        cd = self._ntt_scheme(ct, "mod switch")
        if ct.level >= self.context.last_level:
            raise ValueError("already at the last level")
        if cd.scheme == SchemeType.ckks:
            return ct.replace(data=ct.data[:, :-1], level=ct.level + 1)
        if cd.scheme == SchemeType.bgv:
            data = drns.mod_t_and_divide_q_last_ntt(ct.data, cd.ntt,
                                                    cd.bgv_mod_switch_consts)
            cf = (ct.correction_factor * cd.rns_tool.inv_q_last_mod_t
                  % int(cd.plain_modulus))
            return ct.replace(data=data, level=ct.level + 1,
                              correction_factor=cf)
        if ct.is_ntt_form:
            raise ValueError("the BFV mod switch expects coefficient form")
        return ct.replace(data=dks.divide_and_round_q_last(ct.data, cd.ntt),
                          level=ct.level + 1)

    def mod_switch_to(self, ct: Ciphertext, level: int) -> Ciphertext:
        if level < ct.level:
            raise ValueError("cannot switch to a higher level")
        while ct.level < level:
            ct = self.mod_switch_to_next(ct)
        return ct

    def mod_switch_plain_to_next(self, plain: Plaintext) -> Plaintext:
        """Drop an NTT-form plaintext's last limb (a view)."""
        if not plain.is_ntt_form or plain.level is None:
            raise ValueError("only NTT-form plaintexts carry levels")
        if plain.level >= self.context.last_level:
            raise ValueError("already at the last level")
        return dataclasses.replace(plain, data=plain.data[:-1],
                                   level=plain.level + 1)

    def mod_switch_plain_to(self, plain: Plaintext, level: int) -> Plaintext:
        while plain.level < level:
            plain = self.mod_switch_plain_to_next(plain)
        return plain

    def rescale_to_next(self, ct: Ciphertext) -> Ciphertext:
        """CKKS: divide by the level's last prime with rounding, in the NTT
        domain (kernels A and K'), and the scale by that prime
        (troy_tpu/evaluator.py:1035)."""
        self._ckks("rescale")
        cd = self._cd(ct)
        if ct.level >= self.context.last_level:
            raise ValueError("already at the last level")
        data = drns.divide_and_round_q_last_ntt(ct.data, cd.ntt,
                                                cd.rescale_consts)
        return ct.replace(data=data, level=ct.level + 1,
                          scale=ct.scale / cd.coeff_values[-1])

    def rescale_to(self, ct: Ciphertext, level: int) -> Ciphertext:
        while ct.level < level:
            ct = self.rescale_to_next(ct)
        return ct

    # ---- plaintext ops (evaluator_cuda.cuh:160-260) ----
    def add_plain(self, ct: Ciphertext, plain: Plaintext,
                  subtract: bool = False) -> Ciphertext:
        """c0 +/- the plaintext: BFV round(Q/t m) (kernel G); CKKS an
        NTT-form plaintext at the ciphertext's level and scale (D); BGV the
        centred lift of m cf mod t, transformed (AGp, or G' and J; then D)
        (troy_tpu/evaluator.py:1070-1097). The new ciphertext's c0 is
        written and its c1 copied by that one G or D launch."""
        cd = self._ntt_scheme(ct, "add_plain")
        data = ct.data
        if cd.scheme == SchemeType.bfv:
            if plain.is_ntt_form:
                raise ValueError("BFV add_plain expects a mod-t plaintext")
            return ct.replace(data=dpoly.bfv_plain_embed_c0(
                data, _pad(plain.data, cd.n), *rlwe.bfv_embed_args(cd),
                cd.ntt, subtract))
        if cd.scheme == SchemeType.ckks:
            if not plain.is_ntt_form or plain.level != ct.level:
                raise ValueError("CKKS plain must be NTT form at the "
                                 "ciphertext's level")
            if not _scales_close(ct.scale, plain.scale):
                raise ValueError("CKKS scales mismatch in add_plain")
            m = plain.data
        else:
            if plain.is_ntt_form:
                raise ValueError("BGV add_plain expects a mod-t plaintext")
            m = _plain_to_ntt(_pad(plain.data, cd.n), cd,
                              ct.correction_factor)
        return ct.replace(data=dpoly.rns_add_c0(data, m, cd.ntt, subtract))

    def sub_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self.add_plain(ct, plain, subtract=True)

    def multiply_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        """Every component times the plaintext in the NTT domain (kernel B):
        a mod-t plaintext lifted centred and transformed first (G', A); a
        BFV ciphertext transformed there and back (A)
        (troy_tpu/evaluator.py:1102-1136)."""
        cd = self._ntt_scheme(ct, "multiply_plain")
        if plain.is_ntt_form:
            if plain.level != ct.level:
                raise ValueError("NTT-form plaintext level mismatch")
            m = plain.data
        elif cd.scheme == SchemeType.ckks or (
                cd.scheme == SchemeType.bfv and ct.is_ntt_form):
            raise ValueError("need an NTT-form plaintext at the "
                             "ciphertext's level")
        else:
            m = _plain_to_ntt(_pad(plain.data, cd.n), cd)
        if ct.is_ntt_form:
            data = _multiply_plain_ntt(ct.data, m, cd)
        else:
            # a mod-t plaintext's product takes the lazy transform
            # (troy_tpu/evaluator.py:726-736), an NTT-form one's the
            # reduced one: the same words, as B reduces fully
            fwd = dntt.rns_ntt_forward(ct.data, cd.ntt,
                                       lazy=not plain.is_ntt_form)
            data = dntt.rns_ntt_inverse(_multiply_plain_ntt(fwd, m, cd),
                                        cd.ntt)
        if cd.scheme == SchemeType.ckks:
            return ct.replace(data=data, scale=ct.scale * plain.scale)
        return ct.replace(data=data)

    # ---- NTT transforms (evaluator_cuda.cuh transformToNtt/FromNtt) ----
    def transform_to_ntt(self, ct: Ciphertext) -> Ciphertext:
        if ct.is_ntt_form:
            raise ValueError("already NTT form")
        return ct.replace(data=dntt.rns_ntt_forward(ct.data,
                                                    self._cd(ct).ntt),
                          is_ntt_form=True)

    def transform_from_ntt(self, ct: Ciphertext) -> Ciphertext:
        if not ct.is_ntt_form:
            raise ValueError("not in NTT form")
        return ct.replace(data=dntt.rns_ntt_inverse(ct.data,
                                                    self._cd(ct).ntt),
                          is_ntt_form=False)

    def transform_plain_to_ntt(self, plain: Plaintext,
                               level: int) -> Plaintext:
        """Lift and transform a mod-t plaintext at a chain level, for
        repeated multiply_plain (kernels G', A)."""
        if plain.is_ntt_form:
            raise ValueError("already NTT form")
        cd = self.context.get_context_data(level)
        return Plaintext(data=_plain_to_ntt(_pad(plain.data, cd.n), cd),
                         level=level, is_ntt_form=True, scale=plain.scale)

    # ---- Galois / rotations (evaluator_cuda.cu:2024-2150) ----
    def apply_galois(self, ct: Ciphertext, elt: int,
                     galois_keys: GaloisKeys) -> Ciphertext:
        """The automorphism x -> x^elt of a size-2 ciphertext, key-switched
        back to s, in the ciphertext's domain."""
        if ct.size != 2:
            raise ValueError("apply_galois expects size-2 ciphertexts "
                             "(relinearize first)")
        cd = self._galois_level(ct, "apply_galois")
        if not galois_keys.has_key(elt):
            raise ValueError(f"Galois key for element {elt} not present")
        data = _apply_galois_core(ct.data, elt, galois_keys.keys[elt], cd,
                                  self.context.key_context_data,
                                  ct.is_ntt_form)
        return ct.replace(data=data)

    def _prepermuted_key(self, galois_keys: GaloisKeys,
                         elt: int) -> torch.Tensor:
        """The switching key of ``elt`` permuted by the inverse automorphism
        along the evaluation axis (one kernel-M gather), LRU-cached per
        (key object, elt) and identity-checked on every hit, so distinct
        GaloisKeys sharing an element each get their own entry and a
        regenerated key never serves a stale permutation
        (troy_tpu/evaluator.py:1175)."""
        src = galois_keys.keys[elt]
        cache_key = (id(src), elt)
        hit = self._pp_keys.get(cache_key)
        if hit is not None and hit[0] is src:
            self._pp_keys.move_to_end(cache_key)
            return hit[1]
        pp = dgalois.permute(src, dgalois.ntt_inverse_table(
            self.context.n, elt, src.device))
        self._pp_keys[cache_key] = (src, pp)
        while len(self._pp_keys) > self.PP_KEY_CACHE_MAX:
            self._pp_keys.popitem(last=False)
        return pp

    def _prepermuted_stack(self, galois_keys: GaloisKeys,
                           elts: Sequence[int], cd: ContextData
                           ) -> torch.Tensor:
        """The pre-permuted keys of ``elts`` restricted to the level and
        stacked (k, m, 2, used, n) for one B launch; made once per (key
        objects, elements, level) and identity-checked like the keys."""
        srcs = tuple(galois_keys.keys[e] for e in elts)
        cache_key = (tuple(id(s) for s in srcs), tuple(elts), cd.limbs)
        hit = self._pp_stacks.get(cache_key)
        if hit is not None and all(a is b for a, b in zip(hit[0], srcs)):
            self._pp_stacks.move_to_end(cache_key)
            return hit[1]
        kf = self.context.key_context_data.limbs
        stack = torch.stack([_key_rows(self._prepermuted_key(galois_keys, e),
                                       cd.limbs, kf) for e in elts], dim=1)
        self._pp_stacks[cache_key] = (srcs, stack)
        while len(self._pp_stacks) > self.PP_STACK_CACHE_MAX:
            self._pp_stacks.popitem(last=False)
        return stack

    def apply_galois_many(self, ct: Ciphertext, elts: Sequence[int],
                          galois_keys: GaloisKeys) -> List[Ciphertext]:
        """Hoisted multi-automorphism (troy_tpu/evaluator.py:1199): c1's
        digits decomposed and transformed once and shared by every
        element's key switch, against keys pre-permuted by the inverse
        automorphism; one call each of AF, B, the divide and M for all
        the elements (``_hoisted_galois_core``). Not word-equal to m
        apply_galois calls; decrypts the same. Below HOIST_MIN_M elements
        it is those calls (the JAX package's dispatch schedule does the
        same below its own crossover, troy_tpu/evaluator.py:1221-1230)."""
        if ct.size != 2:
            raise ValueError("apply_galois_many expects size-2 ciphertexts "
                             "(relinearize first)")
        if not elts:
            return []
        for elt in elts:
            if not galois_keys.has_key(elt):
                raise ValueError(f"Galois key for element {elt} not present")
        cd = self._galois_level(ct, "apply_galois_many")
        if len(elts) < self.HOIST_MIN_M:
            return [self.apply_galois(ct, e, galois_keys) for e in elts]
        out = _hoisted_galois_core(
            ct.data, list(elts), self._prepermuted_stack(galois_keys, elts,
                                                         cd),
            cd, self.context.key_context_data, ct.is_ntt_form)
        return [ct.replace(data=out[i]) for i in range(len(elts))]

    def rotate_many(self, ct: Ciphertext, steps: Sequence[int],
                    galois_keys: GaloisKeys) -> List[Ciphertext]:
        """Rotations of one ciphertext by several steps (rows for BFV and
        BGV, the vector for CKKS): the steps whose Galois key is present
        share one hoisted decomposition (``apply_galois_many``); the rest
        go through the NAF one by one; step 0 gives a fresh object
        (troy_tpu/evaluator.py:1264)."""
        n = self.context.n
        direct = [(i, galois_util.get_elt_from_step(n, s))
                  for i, s in enumerate(steps)
                  if s != 0 and galois_keys.has_key(
                      galois_util.get_elt_from_step(n, s))]
        results: List[Optional[Ciphertext]] = [None] * len(steps)
        if direct:
            rotated = self.apply_galois_many(
                ct, [elt for _, elt in direct], galois_keys)
            for (i, _), r in zip(direct, rotated):
                results[i] = r
        for i, s in enumerate(steps):
            if results[i] is None:
                results[i] = ct.replace() if s == 0 else \
                    self._rotate_internal(ct, s, galois_keys)
        return results

    def _rotate_internal(self, ct: Ciphertext, steps: int,
                         galois_keys: GaloisKeys) -> Ciphertext:
        if steps == 0:
            return ct
        elt = galois_util.get_elt_from_step(self.context.n, steps)
        if galois_keys.has_key(elt):
            return self.apply_galois(ct, elt, galois_keys)
        # NAF-decompose into power-of-two hops (evaluator_cuda.cu:2150+)
        parts = [p for p in numth.naf(steps) if p != 0]
        if parts == [steps]:
            raise ValueError(f"Galois key for rotation step {steps} "
                             "not present")
        for part in parts:
            ct = self._rotate_internal(ct, part, galois_keys)
        return ct

    def rotate_rows(self, ct: Ciphertext, steps: int,
                    galois_keys: GaloisKeys) -> Ciphertext:
        """BFV/BGV: rotate both rows of the 2 x (n/2) slot matrix left by
        steps."""
        self._batching("rotate_rows")
        return self._rotate_internal(ct, steps, galois_keys)

    def rotate_columns(self, ct: Ciphertext,
                       galois_keys: GaloisKeys) -> Ciphertext:
        """BFV/BGV: swap the two rows of the slot matrix (element
        2n - 1)."""
        self._batching("rotate_columns")
        return self.apply_galois(ct, 2 * self.context.n - 1, galois_keys)

    def rotate_vector(self, ct: Ciphertext, steps: int,
                      galois_keys: GaloisKeys) -> Ciphertext:
        """CKKS: rotate the n/2 slots left by steps."""
        self._ckks("rotate_vector")
        return self._rotate_internal(ct, steps, galois_keys)

    def complex_conjugate(self, ct: Ciphertext,
                          galois_keys: GaloisKeys) -> Ciphertext:
        """CKKS: conjugate every slot (element 2n - 1)."""
        self._ckks("complex_conjugate")
        return self.apply_galois(ct, 2 * self.context.n - 1, galois_keys)

    # ---- the negacyclic shift and LWE (evaluator_cuda.cu:2185-2341) ----
    def negacyclic_shift(self, ct: Ciphertext, shift: int) -> Ciphertext:
        """The ciphertext times x^shift mod x^n + 1, coefficient form
        (kernel N1)."""
        if ct.is_ntt_form:
            raise ValueError("negacyclic shift expects coefficient form")
        cd = self._cd(ct)
        return ct.replace(data=dpoly.negacyclic_shift(ct.data, shift,
                                                      cd.ntt))

    def extract_lwe(self, ct: Ciphertext, term: int) -> LWECiphertext:
        """Coefficient ``term`` as an LWE sample (evaluator_cuda.cu:
        2216-2249)."""
        return self.extract_lwe_many(ct, [term])[0]

    def extract_lwe_many(self, ct: Ciphertext,
                         terms: Sequence[int]) -> List[LWECiphertext]:
        """The LWE samples of several coefficients in one kernel-N1 launch,
        which reads c1 once (troy_tpu/evaluator.py:1351); an NTT-form
        ciphertext is transformed back first. Terms must lie in [0, n)."""
        if ct.size != 2:
            raise ValueError("extract_lwe expects size-2 ciphertexts")
        cd = self._cd(ct)
        if ct.is_ntt_form:
            ct = self.transform_from_ntt(ct)
        n = cd.n
        bad = [t for t in terms if not 0 <= t < n]
        if bad:
            raise ValueError(f"extract_lwe_many terms out of [0, {n}): "
                             f"{bad[:4]}")
        shifts = torch.tensor([0 if t == 0 else 2 * n - t for t in terms],
                              dtype=torch.int64).to(cd.device)
        c1s, c0s = dpoly.extract_lwe_many(ct.data, shifts, cd.ntt)
        return [LWECiphertext(c1=c1s[i], c0=c0s[i], level=ct.level,
                              scale=ct.scale,
                              correction_factor=ct.correction_factor)
                for i in range(len(terms))]

    def assemble_lwe(self, lwe: LWECiphertext, term: int = 0) -> Ciphertext:
        """An LWE sample as a coefficient-form ciphertext whose coefficient
        ``term`` carries the value (evaluator_cuda.cu:2185-2207; kernel
        N1)."""
        cd = self.context.get_context_data(lwe.level)
        if not 0 <= term < cd.n:
            raise ValueError(f"assemble_lwe term {term} out of [0, {cd.n})")
        data = dpoly.assemble_lwe(lwe.c1.unsqueeze(0), lwe.c0.unsqueeze(0),
                                  term, cd.ntt)[0]
        return Ciphertext(data=data, level=lwe.level, is_ntt_form=False,
                          scale=lwe.scale,
                          correction_factor=lwe.correction_factor)

    def divide_by_poly_modulus_degree(self, ct: Ciphertext,
                                      mul: int = 1) -> Ciphertext:
        """Every coefficient times n^-1 (times mul), one kernel-D launch
        (evaluator_cuda.cu:2266-2276)."""
        cd = self._cd(ct)
        scalars = [numth.invert_mod(cd.n, q) * mul % q
                   for q in cd.coeff_values]
        return ct.replace(data=dpoly.rns_scalar_mul(ct.data, scalars,
                                                    cd.ntt))

    def _field_trace_steps(self, automorphism_keys: GaloisKeys,
                           logn: int) -> List[Tuple[int, torch.Tensor]]:
        """(element, key) of each trace step x -> x^(d + 1), d = n, n/2,
        ..., 2^(logn+1): outermost first."""
        steps = []
        degree = self.context.n
        while degree > (1 << logn):
            elt = degree + 1
            if not automorphism_keys.has_key(elt):
                raise ValueError(f"Galois key for element {elt} not present")
            steps.append((elt, automorphism_keys.keys[elt]))
            degree >>= 1
        return steps

    def field_trace(self, ct: Ciphertext, automorphism_keys: GaloisKeys,
                    logn: int = 0) -> Ciphertext:
        """The trace down to the subfield of degree 2^logn: each step adds
        the ciphertext's image under x -> x^(d + 1) (one batched fold and
        one D add), in the ciphertext's domain (evaluator_cuda.cu:
        2251-2261). Keeps the coefficients at multiples of n / 2^logn,
        times n / 2^logn, and annihilates the rest."""
        if ct.size != 2:
            raise ValueError("field_trace expects size-2 ciphertexts")
        cd = self._galois_level(ct, "field_trace")
        steps = self._field_trace_steps(automorphism_keys, logn)
        data = self._trace(ct.data.unsqueeze(0), steps, cd, ct.is_ntt_form)
        return ct.replace(data=data[0]) if steps else ct

    def _trace(self, data: torch.Tensor, steps, cd: ContextData,
               ntt_form: bool) -> torch.Tensor:
        """The trace steps over a batch (m, 2, k, n): one batched fold and
        one D add a step, in one ``field_trace`` span."""
        key_cd = self.context.key_context_data
        with profiling.span("field_trace"):
            for elt, key in steps:
                data = dpoly.rns_add(data, _batched_galois_fold(
                    data, elt, key, cd, key_cd, ntt_form), cd.ntt)
        return data

    def pack_lwe_ciphertexts(self, lwes: Sequence[LWECiphertext],
                             automorphism_keys: GaloisKeys) -> Ciphertext:
        """Up to n LWE samples packed into one ciphertext, sample i at
        coefficient i n / 2^l (2^l the count rounded up to a power of two):
        the samples assembled at term 0 and times n^-1 in one N1 launch, in
        bit-reversed order; one tree layer per bit, each an N2 shift and
        fold of all the pairs, one batched fold and one D add; then the
        field trace down to degree 2^l (evaluator_cuda.cu:2278-2341). BFV
        and BGV fold in the coefficient domain, CKKS in the NTT domain, as
        troy_tpu does; the BGV key switch divides in the coefficient domain
        there (kernel K''), where troy_tpu's result is wrong."""
        count = len(lwes)
        if count == 0:
            raise ValueError("no LWE ciphertexts to pack")
        n = self.context.n
        if count > n:
            raise ValueError("too many LWE ciphertexts")
        cd = self.context.get_context_data(lwes[0].level)
        key_cd = self.context.key_context_data
        is_ckks = cd.scheme == SchemeType.ckks
        l = max(count - 1, 0).bit_length()
        zero_c1 = torch.zeros_like(lwes[0].c1)
        zero_c0 = torch.zeros_like(lwes[0].c0)
        order = [numth.reverse_bits(i, l) for i in range(1 << l)]
        c1s = torch.stack([lwes[i].c1 if i < count else zero_c1
                           for i in order])
        c0s = torch.stack([lwes[i].c0 if i < count else zero_c0
                           for i in order])
        inv_n = [numth.invert_mod(n, q) for q in cd.coeff_values]
        cur = dpoly.assemble_lwe(c1s, c0s, 0, cd.ntt, inv_n)
        for layer in range(l):
            elt = (1 << (layer + 1)) + 1
            if not automorphism_keys.has_key(elt):
                raise ValueError(f"Galois key for element {elt} not present")
            key = automorphism_keys.keys[elt]
            even, folded = dpoly.pack_fold_prepare(cur, n >> (layer + 1),
                                                   cd.ntt)
            if is_ckks:
                rotated = dntt.rns_ntt_inverse(_batched_galois_fold(
                    dntt.rns_ntt_forward(folded, cd.ntt), elt, key, cd,
                    key_cd, True), cd.ntt)
            else:
                rotated = _batched_galois_fold(folded, elt, key, cd, key_cd,
                                               False)
            cur = dpoly.rns_add(even, rotated, cd.ntt)
        template = lwes[0]
        ret = Ciphertext(data=cur[0], level=template.level,
                         is_ntt_form=False, scale=template.scale,
                         correction_factor=template.correction_factor)
        if is_ckks:
            ret = self.transform_to_ntt(ret)
        return self.field_trace(ret, automorphism_keys, l)
