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
    ciphertext: in the coefficient domain after an inverse A (F), or in the
    NTT domain (A on the special row, K', A, K'; for BGV the t-corrected
    temps of K'-BGV);
  * ``apply_galois`` permutes both components (kernel M: signed in the
    coefficient domain, a plain gather in the NTT domain) before the key
    switch of c1; BFV's ``mod_switch_to_next`` divides by the level's last
    prime (kernel K), CKKS's drops it, BGV's subtracts a multiple of t and
    divides in the NTT domain (A, K'-BGV) and carries the correction factor
    times q_last^-1 mod t, and ``rescale_to_next`` divides by it in the NTT
    domain (K'); BGV add and sub first balance unequal correction factors
    (D's scalar multiply);
  * a mod-t plaintext enters BFV's add_plain through the plain embedding
    (kernel G) and every multiply_plain, and BGV's add_plain, through the
    plain lift (kernel G') and A; the product with a plaintext is one
    B launch over every component.

The ops run on the CPU too, on the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .context import ContextData, HeContext
from .he_types import (Ciphertext, GaloisKeys, KSwitchKeys, Plaintext,
                       RelinKeys)
from .params import SchemeType
from .ops import galois as dgalois
from .ops import keyswitch as dks
from .ops import ntt as dntt
from .ops import poly as dpoly
from .ops import rns as drns
from .utils import galois as galois_util
from .utils import numth

def _scales_close(a: float, b: float) -> bool:
    return abs(a - b) <= max(abs(a), abs(b)) * 1e-9


def _dyadic_convolution(a: torch.Tensor, b: torch.Tensor,
                        tables: dntt.RnsNttTables) -> torch.Tensor:
    """Ciphertext-degree convolution of NTT-domain components
    (kernelutils.cu:89-115): out[m] = sum_{i+j=m} a[i] * b[j], each output
    component one kernel-B launch with its terms summed in 128 bits.
    a: (s1, k, n), b: (s2, k, n), inputs lazy below 4q."""
    s1, s2 = a.shape[0], b.shape[0]
    outs = []
    for m in range(s1 + s2 - 1):
        lo, hi = max(0, m - s2 + 1), min(s1, m + 1)      # i in [lo, hi)
        # a[lo:hi] pairs with b[m-lo], ..., b[m-hi+1]: slices, so no index
        # list goes to the device
        outs.append(dntt.dyadic_mac(a[lo:hi], b[m - hi + 1:m - lo + 1]
                                    .flip(0), tables))
    return torch.stack(outs)


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
    both = d1 if d2 is None else torch.cat([d1, d2])    # every component
    rows = torch.cat([both, drns.behz_lift(both, tool)], dim=-2)  # q u Bsk
    rows_ntt = dntt.rns_ntt_forward(rows, tool.q_bsk, lazy=True)
    b = rows_ntt if d2 is None else rows_ntt[s1:]
    prod = _dyadic_convolution(rows_ntt[:s1], b, tool.q_bsk)
    return drns.behz_tail(dntt.rns_ntt_inverse(prod, tool.q_bsk), tool)


def _switch_key_core(target: torch.Tensor, key: torch.Tensor,
                     cd: ContextData, key_cd: ContextData,
                     acc: Optional[torch.Tensor] = None,
                     ntt_form: bool = False) -> torch.Tensor:
    """The key switch (evaluator_cuda.cu:1163-1362) of a target (k, n) under
    key (decomp, 2, key_limbs, n), NTT form: (2, k, n) in the target's
    domain, with acc (a, k, n), a <= 2, added onto its first a components.

    An NTT-form target's digits are its inverse transform reduced into
    every used prime and transformed again, k x (k+1) rows: the JAX
    package's diagonal shortcut (troy_tpu/evaluator.py:197-224, which
    reuses the k diagonal rows) gives the same words and is not taken."""
    k = cd.limbs
    kf = key_cd.limbs
    used = key_cd.ntt.select(dks.used_limbs(k, kf))
    if ntt_form:
        target = dntt.rns_ntt_inverse(target, cd.ntt)
    # RNS digits of the target in every used prime, NTT'd: (k, used, n)
    t_hat = dntt.rns_ntt_forward(dks.keyswitch_digits(target, used), used)
    # the key's rows over the working base; at the first level that is the
    # whole key
    key_used = key[:k] if k == kf - 1 else torch.cat(
        [key[:k, :, :k], key[:k, :, -1:]], dim=2)
    prods = dntt.dyadic_mac(t_hat, key_used, used)        # (2, used, n)
    if cd.scheme == SchemeType.bgv:
        # the t-corrected divide (troy_tpu/evaluator.py:320-336)
        return drns.divide_round_last_ntt(
            prods, cd.ntt, used.slice(k, k + 1), cd.bgv_keyswitch_consts, acc,
            drns.BGV_KEYSWITCH)
    consts = dks.divide_round_consts(cd.ntt, key_cd.coeff_values[-1])
    if ntt_form:
        return drns.divide_round_last_ntt(prods, cd.ntt, used.slice(k, k + 1),
                                          consts, acc)
    return dks.divide_round_last(dntt.rns_ntt_inverse(prods, used), consts,
                                 acc)


def _relinearize_core(data: torch.Tensor, keys, cd: ContextData,
                      key_cd: ContextData, ntt_form: bool) -> torch.Tensor:
    """Relinearization (size s -> 2): every c_p (p >= 2) key-switched and
    folded into (c0, c1) (evaluator_cuda.cu:703)."""
    c01 = data[:2]
    for i, key in enumerate(keys):
        c01 = _switch_key_core(data[2 + i], key, cd, key_cd, acc=c01,
                               ntt_form=ntt_form)
    return c01


def _apply_galois_coeff_core(data: torch.Tensor, elt: int, key: torch.Tensor,
                             cd: ContextData,
                             key_cd: ContextData) -> torch.Tensor:
    """Coefficient-domain Galois (troy_tpu/evaluator.py:430): both
    components permuted in one launch, then c1 key-switched and the result
    added onto the permuted c0."""
    src, keep = dgalois.coeff_permutation(cd.n, elt, cd.device)
    permuted = dgalois.apply_permutation_signed(data, src, keep, cd.ntt)
    return _switch_key_core(permuted[1], key, cd, key_cd, acc=permuted[:1])


def _apply_galois_ntt_core(data: torch.Tensor, elt: int, key: torch.Tensor,
                           cd: ContextData,
                           key_cd: ContextData) -> torch.Tensor:
    """NTT-domain Galois (troy_tpu/evaluator.py:417): both components
    gathered in one launch (kernel M, unsigned), then c1 key-switched in
    the NTT domain and the result added onto the permuted c0."""
    perm = dgalois.ntt_permutation(cd.n, elt, cd.device)
    permuted = dgalois.apply_permutation(data, perm)
    return _switch_key_core(permuted[1], key, cd, key_cd, acc=permuted[:1],
                            ntt_form=True)


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
    """A mod-t plaintext (n,) lifted centred to the level's base (kernel
    G', times cf mod t first when cf != 1) and transformed (A): (k, n)
    (troy_tpu/evaluator.py:708 _plain_to_ntt)."""
    lifted = dpoly.plain_lift(m, cd.ntt, int(cd.plain_modulus),
                              cd.plain_upper_half_threshold,
                              cd.total_coeff_modulus, correction_factor)
    return dntt.rns_ntt_forward(lifted, cd.ntt)


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
    a correction factor)."""

    def __init__(self, context: HeContext):
        self.context = context

    def _cd(self, ct: Ciphertext) -> ContextData:
        return self.context.get_context_data(ct.level)

    def _ntt_scheme(self, ct: Ciphertext, what: str) -> ContextData:
        """The level of a CKKS or BGV ciphertext, which must be in NTT form
        for ``what``."""
        cd = self._cd(ct)
        if cd.scheme != SchemeType.bfv and not ct.is_ntt_form:
            raise ValueError(f"{cd.scheme.name} {what} expects NTT form")
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
        if cd.scheme == SchemeType.bgv and cf != b.correction_factor:
            cf, e1, e2 = _balance_correction_factors(
                cf, b.correction_factor, int(cd.plain_modulus))
            da = dpoly.rns_broadcast_scalar_mul(da, e1, t)
            db = dpoly.rns_broadcast_scalar_mul(db, e2, t)
        s = min(a.size, b.size)
        op = dpoly.rns_sub if subtract else dpoly.rns_add
        parts = [op(da[:s], db[:s], t)]
        if a.size > s:
            parts.append(da[s:])
        elif b.size > s:
            parts.append(dpoly.rns_neg(db[s:], t) if subtract else db[s:])
        return a.replace(data=torch.cat(parts), correction_factor=cf)

    def add_many(self, cts: Sequence[Ciphertext]) -> Ciphertext:
        acc = cts[0]
        for c in cts[1:]:
            acc = self.add(acc, c)
        return acc

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

    def square(self, ct: Ciphertext) -> Ciphertext:
        """BFV: the dedicated square, one BEHZ lift of ct's components
        (multiply(ct, ct) lifts them twice). CKKS and BGV: the convolution
        of ct with itself, whose cross term a0 a1 + a1 a0 is one two-term
        kernel-B launch (the same fully reduced words as the JAX package's
        doubled product)."""
        return self._multiply(ct, None)

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
                                acc=ct.data[:1], ntt_form=ct.is_ntt_form)
        return ct.replace(data=data)

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
        centred lift of m cf mod t, transformed (G', A, D)
        (troy_tpu/evaluator.py:1070-1097)."""
        cd = self._ntt_scheme(ct, "add_plain")
        data = ct.data
        if cd.scheme == SchemeType.bfv:
            if plain.is_ntt_form:
                raise ValueError("BFV add_plain expects a mod-t plaintext")
            c0 = dpoly.bfv_plain_embed(
                _pad(plain.data, cd.n), data[0], int(cd.plain_modulus),
                cd.coeff_modulus_mod_plain_modulus,
                cd.coeff_div_plain_modulus, cd.ntt, subtract)
        else:
            if cd.scheme == SchemeType.ckks:
                if not plain.is_ntt_form or plain.level != ct.level:
                    raise ValueError("CKKS plain must be NTT form at the "
                                     "ciphertext's level")
                if not _scales_close(ct.scale, plain.scale):
                    raise ValueError("CKKS scales mismatch in add_plain")
                m = plain.data
            else:
                if plain.is_ntt_form:
                    raise ValueError("BGV add_plain expects a mod-t "
                                     "plaintext")
                m = _plain_to_ntt(_pad(plain.data, cd.n), cd,
                                  ct.correction_factor)
            op = dpoly.rns_sub if subtract else dpoly.rns_add
            c0 = op(data[0], m, cd.ntt)
        return ct.replace(data=torch.cat([c0.unsqueeze(0), data[1:]]))

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
        cd = self._ntt_scheme(ct, "apply_galois")
        if not galois_keys.has_key(elt):
            raise ValueError(f"Galois key for element {elt} not present")
        core = (_apply_galois_ntt_core if ct.is_ntt_form
                else _apply_galois_coeff_core)
        data = core(ct.data, elt, galois_keys.keys[elt], cd,
                    self.context.key_context_data)
        return ct.replace(data=data)

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
