"""Evaluator: add, sub, negate, multiply, square, relinearize, Galois
rotations, the mod switch and (CKKS) the rescale.

The port of troy_tpu/evaluator.py, BFV and CKKS branches. The JAX package
traces each operation into one XLA program; here each step is a kernel
launch over the whole batch of polynomials and limbs it touches:

  * BFV multiply lifts both operands from q to Bsk (kernel E), transforms
    the rows in q and in Bsk together (kernel A), convolves them in the NTT
    domain (kernel B), then transforms back (A) and scales by t, floors by
    Q and converts Bsk -> q (E); CKKS ciphertexts are in NTT form, so their
    multiply and square are the convolution alone (B);
  * a key switch (relinearize, Galois) reduces the target into RNS digits
    (kernel F; an NTT-form target is first inverse-transformed by A),
    transforms them (one A launch over k x (k+1) limbs), takes the 128-bit
    inner product with the key (one B launch for both key components) and
    divides by the special prime with rounding, adding the result onto the
    ciphertext: in the coefficient domain after an inverse A (F), or in the
    NTT domain (A on the special row, K', A, K');
  * ``apply_galois`` permutes both components (kernel M: signed in the
    coefficient domain, a plain gather in the NTT domain) before the key
    switch of c1; BFV's ``mod_switch_to_next`` divides by the level's last
    prime (kernel K), CKKS's drops it, and ``rescale_to_next`` divides by it
    in the NTT domain (K').

The ops run on the CPU too, on the kernels' plain versions. BGV is not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .context import ContextData, HeContext
from .he_types import Ciphertext, GaloisKeys, RelinKeys
from .params import SchemeType
from .ops import galois as dgalois
from .ops import keyswitch as dks
from .ops import ntt as dntt
from .ops import poly as dpoly
from .ops import rns as drns
from .utils import galois as galois_util
from .utils import numth

_LATER = ("is not ported yet (ROADMAP.md, queue 2: BGV, hoisted Galois "
          "and LWE come later)")
_PORTED = (SchemeType.bfv, SchemeType.ckks)


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


def _bfv_multiply(d1: torch.Tensor, d2: torch.Tensor,
                  cd: ContextData) -> torch.Tensor:
    """BEHZ RNS multiplication (evaluator_cuda.cu:283-382): lift to Bsk,
    dyadic-convolve in q and Bsk as one base, scale by t, fast-floor by Q,
    convert Bsk -> q."""
    tool = cd.rns
    s1 = d1.shape[0]
    both = torch.cat([d1, d2])                          # every component
    rows = torch.cat([both, drns.behz_lift(both, tool)], dim=-2)  # q u Bsk
    rows_ntt = dntt.rns_ntt_forward(rows, tool.q_bsk, lazy=True)
    prod = _dyadic_convolution(rows_ntt[:s1], rows_ntt[s1:], tool.q_bsk)
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


class Evaluator:
    """(evaluator.h:72): BFV (coefficient-form ciphertexts) and CKKS
    (NTT-form ciphertexts with a scale)."""

    def __init__(self, context: HeContext):
        self.context = context

    def _cd(self, ct: Ciphertext) -> ContextData:
        cd = self.context.get_context_data(ct.level)
        if cd.scheme not in _PORTED:
            raise NotImplementedError(f"{cd.scheme.name} evaluation "
                                      f"{_LATER}")
        return cd

    def _ckks(self, what: str) -> None:
        if self.context.scheme != SchemeType.ckks:
            raise ValueError(f"{what} is CKKS-only")

    def _bfv(self, what: str) -> None:
        if self.context.scheme != SchemeType.bfv:
            raise ValueError(f"{what} is BFV-only in this port")

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
        self._check_same(a, b)
        cd = self._cd(a)
        if cd.scheme == SchemeType.ckks and not _scales_close(a.scale,
                                                              b.scale):
            raise ValueError(f"CKKS scales mismatch in "
                             f"{'sub' if subtract else 'add'}")
        t = cd.ntt
        s = min(a.size, b.size)
        op = dpoly.rns_sub if subtract else dpoly.rns_add
        parts = [op(a.data[:s], b.data[:s], t)]
        if a.size > s:
            parts.append(a.data[s:])
        elif b.size > s:
            parts.append(dpoly.rns_neg(b.data[s:], t) if subtract
                         else b.data[s:])
        return a.replace(data=torch.cat(parts))

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_same(a, b)
        cd = self._cd(a)
        if cd.scheme == SchemeType.ckks:
            # the NTT-domain convolution (evaluator_cuda.cu:384-432)
            return a.replace(data=_dyadic_convolution(a.data, b.data, cd.ntt),
                             scale=a.scale * b.scale)
        if a.is_ntt_form:
            raise ValueError("BFV multiply expects coefficient form")
        return a.replace(data=_bfv_multiply(a.data, b.data, cd))

    def square(self, ct: Ciphertext) -> Ciphertext:
        """CKKS square (evaluator_cuda.cu:601-646): the convolution of ct
        with itself, whose cross term a0 a1 + a1 a0 is one two-term kernel-B
        launch (the same fully reduced words as the JAX package's doubled
        product). BFV's dedicated square (one lift instead of two) is not
        ported; multiply gives its words."""
        return self.multiply(ct, ct)

    def relinearize(self, ct: Ciphertext,
                    relin_keys: RelinKeys) -> Ciphertext:
        """Reduce the ciphertext size back to 2 (evaluator_cuda.cu:703)."""
        if ct.size == 2:
            return ct
        cd = self._cd(ct)
        keys = tuple(relin_keys.keys[p] for p in range(2, ct.size))
        data = _relinearize_core(ct.data, keys, cd,
                                 self.context.key_context_data,
                                 ct.is_ntt_form)
        return ct.replace(data=data)

    # ---- modulus switching (evaluator_cuda.cu:749+) ----
    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        """Drop the level's last prime (troy_tpu/evaluator.py:998): BFV
        divides by it with rounding, CKKS drops the limb (a view)."""
        cd = self._cd(ct)
        if ct.level >= self.context.last_level:
            raise ValueError("already at the last level")
        if cd.scheme == SchemeType.ckks:
            return ct.replace(data=ct.data[:, :-1], level=ct.level + 1)
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

    # ---- Galois / rotations (evaluator_cuda.cu:2024-2150) ----
    def apply_galois(self, ct: Ciphertext, elt: int,
                     galois_keys: GaloisKeys) -> Ciphertext:
        """The automorphism x -> x^elt of a size-2 ciphertext, key-switched
        back to s, in the ciphertext's domain."""
        if ct.size != 2:
            raise ValueError("apply_galois expects size-2 ciphertexts "
                             "(relinearize first)")
        cd = self._cd(ct)
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
        """Rotate both rows of the 2 x (n/2) slot matrix left by steps."""
        self._bfv("rotate_rows")
        self._cd(ct)
        return self._rotate_internal(ct, steps, galois_keys)

    def rotate_columns(self, ct: Ciphertext,
                       galois_keys: GaloisKeys) -> Ciphertext:
        """Swap the two rows of the slot matrix (element 2n - 1)."""
        self._bfv("rotate_columns")
        return self.apply_galois(ct, 2 * self.context.n - 1, galois_keys)

    def rotate_vector(self, ct: Ciphertext, steps: int,
                      galois_keys: GaloisKeys) -> Ciphertext:
        """CKKS: rotate the n/2 slots left by steps."""
        self._ckks("rotate_vector")
        self._cd(ct)
        return self._rotate_internal(ct, steps, galois_keys)

    def complex_conjugate(self, ct: Ciphertext,
                          galois_keys: GaloisKeys) -> Ciphertext:
        """CKKS: conjugate every slot (element 2n - 1)."""
        self._ckks("complex_conjugate")
        return self.apply_galois(ct, 2 * self.context.n - 1, galois_keys)
