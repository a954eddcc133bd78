"""BatchEncoder: BFV SIMD slot encoding.

The port of troy_tpu/encoder.py (batching path). The 2 x (n/2) slot matrix
maps onto NTT evaluation points through the bit-reversed 3^i orbit index
map (batchencoder.cpp:67-82); encode scatters the slots and runs the
inverse NTT mod t, decode runs the forward NTT mod t and gathers. Both
transforms are kernel A with one limb; the scatter and the gather are
kernel M's unsigned gather (the scatter gathers by the inverse map).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from .context import HeContext
from .he_types import Plaintext
from .interop import to_numpy, to_torch
from .ops import galois as dgalois
from .ops import ntt as dntt
from .utils import numth


class BatchEncoder:
    """(batchencoder.h:48)"""

    def __init__(self, context: HeContext):
        cd = context.first_context_data
        if not cd.qualifiers.using_batching:
            raise ValueError("SIMD batching requires plain_modulus = 1 "
                             "mod 2N")
        self.context = context
        self.n = cd.n
        self.plain_modulus = int(cd.plain_modulus)
        self._tables = context.plain_ntt
        n = self.n
        log_n = numth.get_power_of_two(n)
        m = 2 * n
        index_map = np.zeros(n, dtype=np.int64)
        pos = 1
        for i in range(n // 2):
            index_map[i] = numth.reverse_bits((pos - 1) >> 1, log_n)
            index_map[n // 2 + i] = numth.reverse_bits((m - pos - 1) >> 1,
                                                       log_n)
            pos = (pos * 3) % m
        # the map is a permutation of [0, n): encode gathers by its inverse
        inverse = np.empty_like(index_map)
        inverse[index_map] = np.arange(n)
        self._index_map = torch.from_numpy(index_map).to(context.device)
        self._inverse_map = torch.from_numpy(inverse).to(context.device)

    @property
    def slot_count(self) -> int:
        return self.n

    def encode(self, values: Union[Sequence[int], np.ndarray]) -> Plaintext:
        """Unsigned slot values (mod t) -> coefficient plaintext."""
        values = np.asarray(values, dtype=np.uint64)
        if values.ndim != 1 or len(values) > self.n:
            raise ValueError("too many slot values")
        values = values % np.uint64(self.plain_modulus)
        if len(values) < self.n:
            values = np.pad(values, (0, self.n - len(values)))
        return Plaintext(data=_encode_core(
            to_torch(values, self.context.device), self._inverse_map,
            self._tables))

    def decode(self, plain: Plaintext) -> np.ndarray:
        """Coefficient plaintext -> unsigned slot values (numpy u64)."""
        if plain.is_ntt_form:
            raise ValueError("cannot decode an NTT-form plaintext")
        data = plain.data
        if data.shape[-1] < self.n:
            data = torch.nn.functional.pad(data, (0, self.n - data.shape[-1]))
        return to_numpy(_decode_core(data, self._index_map, self._tables))


def _encode_core(values: torch.Tensor, inverse_map: torch.Tensor,
                 tables: dntt.NttTables) -> torch.Tensor:
    """Slot scatter (evals[index_map] = values, as a gather by the inverse
    map, kernel M) + inverse NTT mod t (batchencoder_cuda.cu:42-73)."""
    return dntt.ntt_inverse(dgalois.apply_permutation(values, inverse_map),
                            tables)


def _decode_core(data: torch.Tensor, index_map: torch.Tensor,
                 tables: dntt.NttTables) -> torch.Tensor:
    """Forward NTT mod t + slot gather (kernel M)
    (batchencoder_cuda.cu:75-118)."""
    return dgalois.apply_permutation(dntt.ntt_forward(data, tables),
                                     index_map)
