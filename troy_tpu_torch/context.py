"""HE context: parameter validation and the modulus-switching chain.

The port of troy_tpu/context.py. One ``ContextData`` per chain level: level
0 holds the full modulus (the key level), each later level drops the last
prime. Each level carries its NTT tables, the BEHZ tool with its device
constants and the plain-embedding scalars (BFV), or the constants of the
NTT-domain divide by its last prime (CKKS rescale); the batching tables
mod t belong to the context and serve every level. Every table lives on
the context's device; levels are referred to by their chain index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .modulus import INTERNAL_MOD_BIT_COUNT, Modulus, SecurityLevel
from .params import (
    EncryptionParameters, EncryptionParameterQualifiers, SchemeType,
    validate,
)
from .interop import DEFAULT_DEVICE
from .utils.rns import make_rns_tool
from .ops.keyswitch import divide_round_consts
from .ops.ntt import NttTables, RnsNttTables
from .ops.rns import DeviceRnsTool


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
    def device(self) -> torch.device:
        return self.ntt.device


def _build_context_data(parms: EncryptionParameters, chain_index: int,
                        qualifiers: EncryptionParameterQualifiers,
                        device: torch.device) -> ContextData:
    n = parms.poly_modulus_degree
    values = parms.coeff_values
    t = int(parms.plain_modulus)

    ntt = RnsNttTables.from_moduli(n, values, device)
    bsk_ntt = rns = rescale = None
    if parms.scheme == SchemeType.bfv:
        rns_tool = make_rns_tool(n, values, t, INTERNAL_MOD_BIT_COUNT)
        bsk_ntt = RnsNttTables.from_moduli(n, rns_tool.base_Bsk.values,
                                           device)
        rns = DeviceRnsTool.build(rns_tool, ntt, bsk_ntt)
    elif parms.scheme == SchemeType.ckks and len(values) > 1:
        rescale = divide_round_consts(ntt.slice(0, len(values) - 1),
                                      values[-1])

    Q = 1
    for v in values:
        Q *= v
    return ContextData(
        ntt=ntt, bsk_ntt=bsk_ntt, rns=rns, parms=parms,
        chain_index=chain_index, qualifiers=qualifiers,
        coeff_div_plain_modulus=tuple((Q // t) % v for v in values) if t
        else (),
        coeff_modulus_mod_plain_modulus=Q % t if t else 0,
        rescale_consts=rescale,
    )


class HeContext:
    """The validated parameter chain (context.h SEALContext analogue).

    ``chain[0]`` is the key level (full modulus); ``chain[1:]`` are data
    levels, each dropping one prime. Every table is made on ``device``,
    the card unless the caller names another (``device="cpu"`` runs the
    plain versions of the kernels); a CUDA device needs a card, and
    without one this raises rather than fall back to the CPU."""

    def __init__(self, parms: EncryptionParameters,
                 expand_mod_chain: bool = True,
                 sec_level: SecurityLevel = SecurityLevel.tc128,
                 device=None):
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
        chain: List[ContextData] = [
            _build_context_data(parms, 0, qualifiers, device)]

        self._using_keyswitching = len(parms.coeff_modulus) > 1
        if self._using_keyswitching:
            level_parms = parms.drop_last()
            idx = 1
            while True:
                q = validate(level_parms, sec_level)
                if not q.parameters_set:
                    raise ValueError(f"invalid parameters at chain level "
                                     f"{idx}: {q.error_message}")
                chain.append(_build_context_data(level_parms, idx, q, device))
                if not expand_mod_chain or len(level_parms.coeff_modulus) == 1:
                    break
                level_parms = level_parms.drop_last()
                idx += 1

        self.chain: Tuple[ContextData, ...] = tuple(chain)
        # batching tables mod t, shared by every level (kernel A, k = 1)
        self.plain_ntt: Optional[NttTables] = None
        if qualifiers.using_batching:
            self.plain_ntt = NttTables.from_modulus(
                parms.poly_modulus_degree, int(parms.plain_modulus), device)

    @property
    def key_context_data(self) -> ContextData:
        return self.chain[0]

    @property
    def first_context_data(self) -> ContextData:
        return self.chain[1] if self._using_keyswitching else self.chain[0]

    @property
    def first_level(self) -> int:
        return 1 if self._using_keyswitching else 0

    @property
    def last_level(self) -> int:
        return len(self.chain) - 1

    def get_context_data(self, level: int) -> ContextData:
        return self.chain[level]

    @property
    def using_keyswitching(self) -> bool:
        return self._using_keyswitching

    @property
    def scheme(self) -> SchemeType:
        return self.chain[0].scheme

    @property
    def n(self) -> int:
        return self.chain[0].n
