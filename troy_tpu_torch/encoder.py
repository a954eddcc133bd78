"""BatchEncoder: BFV SIMD slot encoding.

The port of troy_tpu/encoder.py. The 2 x (n/2) slot matrix
maps onto NTT evaluation points through the bit-reversed 3^i orbit index
map (batchencoder.cpp:67-82); encode scatters the slots and runs the
inverse NTT mod t, decode runs the forward NTT mod t and gathers. Both
transforms are kernel A with one limb; the scatter and the gather are
kernel M's unsigned gather (the scatter gathers by the inverse map).
``encode_polynomial`` and ``decode_polynomial`` carry the raw coefficients
mod t (batchencoder_cuda.cuh:65-75), what the LWE ops and the app layer
encode with; they need no batching modulus.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .context import HeContext
from .he_types import Plaintext
from .interop import to_numpy, to_torch
from .ops import galois as dgalois
from .ops import ntt as dntt
from .utils import numth
from .utils import profiling


class BatchEncoder:
    """(batchencoder.h:48)"""

    def __init__(self, context: HeContext):
        cd = context.first_context_data
        self.context = context
        self.n = cd.n
        self.plain_modulus = int(cd.plain_modulus)
        self._batching = cd.qualifiers.using_batching
        self._tables = context.plain_ntt
        if not self._batching:
            return
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
        # kernel M's packed tables (ops/galois.pack_table: no flags)
        self._index_map = torch.from_numpy(
            index_map.astype(np.int32)).to(context.device)
        self._inverse_map = torch.from_numpy(
            inverse.astype(np.int32)).to(context.device)

    @property
    def slot_count(self) -> int:
        return self.n

    def _require_batching(self) -> None:
        if not self._batching:
            raise ValueError("SIMD batching requires plain_modulus = 1 "
                             "mod 2N; use encode_polynomial instead")

    @profiling.spanned("encode")
    def encode(self, values: Union[Sequence[int], np.ndarray]) -> Plaintext:
        """Unsigned slot values (mod t) -> coefficient plaintext."""
        self._require_batching()
        values = np.asarray(values, dtype=np.uint64)
        if values.ndim != 1 or len(values) > self.n:
            raise ValueError("too many slot values")
        values = values % np.uint64(self.plain_modulus)
        if len(values) < self.n:
            values = np.pad(values, (0, self.n - len(values)))
        return Plaintext(data=_encode_core(
            to_torch(values, self.context.device), self._inverse_map,
            self._tables))

    @profiling.spanned("encode")
    def encode_signed(self, values: Union[Sequence[int], np.ndarray]
                      ) -> Plaintext:
        """Signed slot values, taken mod t."""
        values = np.asarray(values, dtype=np.int64)
        return self.encode((values % self.plain_modulus).astype(np.uint64))

    def decode(self, plain: Plaintext) -> np.ndarray:
        """Coefficient plaintext -> unsigned slot values (numpy u64). A
        plaintext held on the host (as ``Decryptor.decrypt_many`` returns
        them) is moved to the context's device first."""
        if plain.is_ntt_form:
            raise ValueError("cannot decode an NTT-form plaintext")
        self._require_batching()
        data = plain.data.to(self.context.device)
        if data.shape[-1] < self.n:
            data = torch.nn.functional.pad(data, (0, self.n - data.shape[-1]))
        return to_numpy(_decode_core(data, self._index_map, self._tables))

    def decode_signed(self, plain: Plaintext) -> np.ndarray:
        """Slot values centred mod t: those at or above (t + 1) / 2 as
        value - t (int64)."""
        vals = self.decode(plain).astype(np.int64)
        t = self.plain_modulus
        return np.where(vals >= (t + 1) // 2, vals - t, vals)

    @profiling.spanned("encode")
    def encode_polynomial(self, values: Union[Sequence[int], np.ndarray]
                          ) -> Plaintext:
        """Coefficients (mod t, at most n) -> coefficient plaintext."""
        values = np.asarray(values, dtype=np.uint64) % np.uint64(
            self.plain_modulus)
        if values.ndim != 1 or len(values) > self.n:
            raise ValueError("too many coefficients")
        data = np.zeros(self.n, dtype=np.uint64)
        data[:len(values)] = values
        return Plaintext(data=to_torch(data, self.context.device))

    def decode_polynomial(self, plain: Plaintext,
                          count: Optional[int] = None) -> np.ndarray:
        """A coefficient plaintext's words mod t (numpy u64), the first
        ``count`` if given."""
        if plain.is_ntt_form:
            raise ValueError("cannot decode an NTT-form plaintext")
        out = to_numpy(plain.data)
        return out if count is None else out[:count]


def _encode_core(values: torch.Tensor, inverse_map: torch.Tensor,
                 tables: dntt.NttTables) -> torch.Tensor:
    """Slot scatter (evals[index_map] = values, as a gather by the inverse
    map, kernel M) + inverse NTT mod t (batchencoder_cuda.cu:42-73)."""
    return dntt.ntt_inverse(dgalois.permute(values, inverse_map), tables)


def _decode_core(data: torch.Tensor, index_map: torch.Tensor,
                 tables: dntt.NttTables) -> torch.Tensor:
    """Forward NTT mod t + slot gather (kernel M)
    (batchencoder_cuda.cu:75-118)."""
    return dgalois.permute(dntt.ntt_forward(data, tables), index_map)
