"""HE context: parameter validation and the modulus-switching chain.

The port of troy_tpu/context.py. One ``ContextData`` per chain level: level
0 holds the full modulus (the key level), each later level drops the last
prime. Each level carries its NTT tables; BFV and BGV levels their host RNS
tool and the plain lift's scalars and constants (kernel G'); BFV levels the
BEHZ tool with its device constants and the plain-embedding scalars; BGV
levels the constants of the exact conversion to t (kernel X) and of the
t-corrected NTT-domain divides by the last prime (mod switch) and by the
special prime (key switch, kernel K'-BGV); CKKS levels those of the
NTT-domain divide by the last prime (rescale). The batching tables mod t
belong to the context and serve every level. Every table lives on the
context's device; levels are referred to by their chain index.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .modulus import INTERNAL_MOD_BIT_COUNT, Modulus, SecurityLevel
from .params import (
    EncryptionParameters, EncryptionParameterQualifiers, ParmsID, SchemeType,
    validate,
)
from .interop import DEFAULT_DEVICE
from .utils.rns import RnsTool, make_rns_tool
from .ops.keyswitch import bgv_divide_consts, divide_round_consts
from .ops.ntt import NttTables, RnsNttTables
from .ops.poly import plain_lift_consts
from .ops.rns import DeviceRnsTool, ExactConverter
from .utils import profiling


@dataclass(eq=False)
class ContextData:
    """One level of the modulus-switching chain (context.h:437-475)."""

    ntt: RnsNttTables                   # this level's primes
    bsk_ntt: Optional[RnsNttTables]     # BEHZ auxiliary base (BFV only)
    rns: Optional[DeviceRnsTool]        # BEHZ device constants (BFV only)
    parms: EncryptionParameters
    chain_index: int                    # 0 = key level
    qualifiers: EncryptionParameterQualifiers
    coeff_div_plain_modulus: Tuple[int, ...]    # floor(Q/t) mod q_i
    coeff_modulus_mod_plain_modulus: int        # Q mod t
    # CKKS: q_0..q_{k-2}, floor(q_last/2) mod q_i, q_last^-1 mod q_i and its
    # Shoup words (ops/keyswitch.divide_round_consts), for the rescale
    rescale_consts: Optional[torch.Tensor] = None
    # BFV and BGV: the host RNS tool; the centred plain lift's threshold
    # (t+1)/2 and increments (Q - t) mod q_i (context.cpp
    # plain_upper_half_threshold/increment; kernel G''s constants hold them)
    rns_tool: Optional[RnsTool] = None
    plain_upper_half_threshold: int = 0
    plain_upper_half_increment: Tuple[int, ...] = ()
    # BGV: kernel X's converter q -> t (decrypt); kernel K'-BGV's constants
    # for the mod switch (p = q_last over q_0..q_{k-2}) and for the key
    # switch (p = the special prime over this level's q; its p^-1 mod t is
    # the key level's inv_q_last_mod_t)
    exact_to_t: Optional[ExactConverter] = None
    bgv_mod_switch_consts: Optional[torch.Tensor] = None
    bgv_keyswitch_consts: Optional[torch.Tensor] = None

    @property
    def scheme(self) -> SchemeType:
        return self.parms.scheme

    @property
    def n(self) -> int:
        return self.parms.poly_modulus_degree

    @property
    def coeff_modulus(self) -> Tuple[Modulus, ...]:
        return self.parms.coeff_modulus

    @property
    def coeff_values(self) -> Tuple[int, ...]:
        return self.parms.coeff_values

    @property
    def limbs(self) -> int:
        return len(self.parms.coeff_modulus)

    @property
    def total_coeff_modulus(self) -> int:
        Q = 1
        for v in self.coeff_values:
            Q *= v
        return Q

    @property
    def plain_modulus(self) -> Modulus:
        return self.parms.plain_modulus

    @property
    def parms_id(self) -> ParmsID:
        return self.parms.parms_id

    @property
    def device(self) -> torch.device:
        return self.ntt.device

    def replace(self, **changes) -> "ContextData":
        return dataclasses.replace(self, **changes)


def _build_context_data(parms: EncryptionParameters, chain_index: int,
                        qualifiers: EncryptionParameterQualifiers,
                        device: torch.device, special_prime: int,
                        internal_prime_bits: int,
                        use_mxu: Optional[bool]) -> ContextData:
    n = parms.poly_modulus_degree
    values = parms.coeff_values
    k = len(values)
    t = int(parms.plain_modulus)
    Q = 1
    for v in values:
        Q *= v

    ntt = RnsNttTables.from_moduli(n, values, device, use_mxu)
    bsk_ntt = rns = rescale = rns_tool = exact = None
    bgv_ms = bgv_ks = None
    if parms.scheme in (SchemeType.bfv, SchemeType.bgv):
        rns_tool = make_rns_tool(n, values, t, internal_prime_bits)
        plain_lift_consts(ntt, t, Q)                  # uploaded once
    if parms.scheme == SchemeType.bfv:
        bsk_ntt = RnsNttTables.from_moduli(n, rns_tool.base_Bsk.values,
                                           device, use_mxu)
        rns = DeviceRnsTool.build(rns_tool, ntt, bsk_ntt)
    elif parms.scheme == SchemeType.bgv:
        exact = ExactConverter.build(rns_tool.conv_q_to_t, device)
        if k > 1:
            bgv_ms = bgv_divide_consts(ntt.slice(0, k - 1), values[-1], t)
        if chain_index > 0:
            bgv_ks = bgv_divide_consts(ntt, special_prime, t)
    elif parms.scheme == SchemeType.ckks and k > 1:
        rescale = divide_round_consts(ntt.slice(0, k - 1), values[-1])

    return ContextData(
        ntt=ntt, bsk_ntt=bsk_ntt, rns=rns, parms=parms,
        chain_index=chain_index, qualifiers=qualifiers,
        coeff_div_plain_modulus=tuple((Q // t) % v for v in values) if t
        else (),
        coeff_modulus_mod_plain_modulus=Q % t if t else 0,
        rescale_consts=rescale, rns_tool=rns_tool,
        plain_upper_half_threshold=(t + 1) >> 1 if t else 0,
        plain_upper_half_increment=tuple((Q - t) % v for v in values) if t
        else (),
        exact_to_t=exact, bgv_mod_switch_consts=bgv_ms,
        bgv_keyswitch_consts=bgv_ks,
    )


class HeContext:
    """The validated parameter chain (context.h SEALContext analogue).

    ``chain[0]`` is the key level (full modulus); ``chain[1:]`` are data
    levels, each dropping one prime. Every table is made on ``device``,
    the card unless the caller names another (``device="cpu"`` runs the
    plain versions of the kernels); a CUDA device needs a card, and
    without one this raises rather than fall back to the CPU.

    ``internal_prime_bits``: the width of the BFV BEHZ auxiliary-base
    primes; None or 61 is troy's choice (rns.cpp getPrimes(61, ...)), 34-60
    narrower primes (utils/rns.RnsTool).

    ``use_mxu``: which kernel runs the NTTs of every level's q and Bsk
    tables and of the batching tables mod t (ops/ntt.py): True, kernel J
    (the 4-step transform's stages as butterflies) at any n >= 2048;
    False, kernel A at any n; None, A up to ops/ntt.py's MAX_KERNEL_N
    (131072) and J above. Both give the same words."""

    @profiling.spanned("context")
    def __init__(self, parms: EncryptionParameters,
                 expand_mod_chain: bool = True,
                 sec_level: SecurityLevel = SecurityLevel.tc128,
                 use_mxu: Optional[bool] = None,
                 internal_prime_bits: Optional[int] = None, device=None):
        device = torch.device(DEFAULT_DEVICE if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"HeContext: device {device} requested but "
                               "CUDA is not available")
        qualifiers = validate(parms, sec_level)
        if not qualifiers.parameters_set:
            raise ValueError(f"invalid encryption parameters: "
                             f"{qualifiers.error_message}")
        self.sec_level = sec_level
        self.device = device
        self.internal_prime_bits = internal_prime_bits
        self.use_mxu = use_mxu
        bits = internal_prime_bits or INTERNAL_MOD_BIT_COUNT
        special = parms.coeff_values[-1]
        chain: List[ContextData] = [
            _build_context_data(parms, 0, qualifiers, device, special, bits,
                                use_mxu)]

        self._using_keyswitching = len(parms.coeff_modulus) > 1
        if self._using_keyswitching:
            level_parms = parms.drop_last()
            idx = 1
            while True:
                q = validate(level_parms, sec_level)
                if not q.parameters_set:
                    raise ValueError(f"invalid parameters at chain level "
                                     f"{idx}: {q.error_message}")
                chain.append(_build_context_data(level_parms, idx, q, device,
                                                 special, bits, use_mxu))
                if not expand_mod_chain or len(level_parms.coeff_modulus) == 1:
                    break
                level_parms = level_parms.drop_last()
                idx += 1

        self.chain: Tuple[ContextData, ...] = tuple(chain)
        self._by_parms_id = {cd.parms_id: cd for cd in chain}
        # batching tables mod t, shared by every level (k = 1)
        self.plain_ntt: Optional[NttTables] = None
        if qualifiers.using_batching:
            self.plain_ntt = NttTables.from_modulus(
                parms.poly_modulus_degree, int(parms.plain_modulus), device,
                use_mxu)

    @property
    def key_context_data(self) -> ContextData:
        return self.chain[0]

    @property
    def first_context_data(self) -> ContextData:
        return self.chain[1] if self._using_keyswitching else self.chain[0]

    @property
    def last_context_data(self) -> ContextData:
        return self.chain[-1]

    @property
    def first_level(self) -> int:
        return 1 if self._using_keyswitching else 0

    @property
    def last_level(self) -> int:
        return len(self.chain) - 1

    def get_context_data(self, level: int) -> ContextData:
        return self.chain[level]

    def get_context_data_by_parms_id(self, pid: ParmsID
                                     ) -> Optional[ContextData]:
        return self._by_parms_id.get(pid)

    @property
    def using_keyswitching(self) -> bool:
        return self._using_keyswitching

    @property
    def scheme(self) -> SchemeType:
        return self.chain[0].scheme

    @property
    def n(self) -> int:
        return self.chain[0].n
