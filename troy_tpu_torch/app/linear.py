"""HE linear algebra: Cheetah-style coefficient-packed matmul and conv2d.

The port of troy_tpu/app/linear.py (reference: app/LinearHelper.cuh:
Plain2d/Cipher2d :21-206, MatmulHelper :228-750 with the tiling search
:242-307, the reversed-coefficient weight encoding :309-326, LWE-trace
output packing :592-650 and saveTerms serialization :686-750; Conv2dHelper
:753-1195 with its 5-dim block search). Scheme-agnostic: the helpers take a
polynomial-coefficient encoder, BatchEncoder.encode_polynomial for BFV and
BGV or CKKSEncoder.encode_polynomial for CKKS.

The device work of a whole grid of tiles runs as a few launches, whatever
the grid's size:
  * ct x pt (``matmul``, ``matmul_reverse``, ``conv2d``,
    ``conv2d_reverse``): the ciphertext tiles' forward NTT (BFV; CKKS and
    BGV tiles arrive in NTT form) one launch, the contraction one launch of
    kernel P1, the inverse NTT one launch. The plaintext grid is stacked,
    and its mod-t tiles lifted and transformed (AGp: G' in A's first pass),
    on a Plain2d's first contraction only: the result is kept on the
    Plain2d (``_prepared_plain``), so weights encoded once and used for
    every request cost their stack and transform once;
  * ct x ct (``matmul_cipher``, ``conv2d_cipher``): BFV lifts and
    transforms every tile once (E, A); per inner index, one P2 launch over
    the X x Yc pair grid (BFV: then one inverse A and one E tail over every
    product) and one D add into the sum;
  * ``pack_outputs``: one N1 pre-shift over all outputs, the n^-1 mul
    prescale (one D launch), each field-trace step as one batched fold over
    all outputs, and the group fold (P3, one launch).
The JAX package's per-dispatch caps (``_MAX_*_PER_DISPATCH``) bounded its
compiler's program size and the v5e's 15.75 GB plan; the split was
word-neutral, and the largest configuration here (the conv2d of troy's
benchmark: 872 MB of NTT-form weight tiles at n = 16384, kept beside the
436 MB of mod-t tiles) is far inside the H100's 80 GB, so the port does
not split.

Decryption and the wire go through ``Decryptor.decrypt_many`` and the
serialization module, one device->host copy per output sweep.
"""

from __future__ import annotations

import itertools
import struct as _struct
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import serialization as ser
from ..context import ContextData, HeContext
from ..decryptor import Decryptor
from ..encryptor import Encryptor
from ..evaluator import (Evaluator, _bfv_lift_ntt, _pad, _pair_grid_multiply,
                         _plain_to_ntt)
from ..he_types import Ciphertext, GaloisKeys, Plaintext, RelinKeys
from ..interop import DEFAULT_DEVICE
from ..ops import ntt as dntt
from ..ops import poly as dpoly
from ..ops import tiles as dtiles
from ..params import SchemeType
from ..utils import numth
from ..utils import profiling


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _stack_grid(grid, transpose: bool = False) -> torch.Tensor:
    """A rectangular grid of ciphertexts or plaintexts as one tensor (rows,
    cols, ...), or (cols, rows, ...) with ``transpose``: one stack."""
    rows, cols = len(grid), len(grid[0])
    if transpose:
        flat = [grid[r][c].data for c in range(cols) for r in range(rows)]
        rows, cols = cols, rows
    else:
        flat = [x.data for row in grid for x in row]
    return torch.stack(flat).reshape((rows, cols) + flat[0].shape)


def _lift_plain_tiles(pt_tiles: torch.Tensor,
                      cd: ContextData) -> torch.Tensor:
    """Mod-t plaintext tiles (..., n or fewer) padded, lifted to the
    level's base and transformed (AGp): (..., k, n)."""
    with profiling.span("tiles_plain_ntt"):
        return _plain_to_ntt(_pad(pt_tiles, cd.n), cd)


def _matmul_tiles_core(ct_tiles: torch.Tensor, pt_tiles: torch.Tensor,
                       cd: ContextData, ct_coeff: bool,
                       pt_mod_t: bool) -> torch.Tensor:
    """The ct x pt tile fan-out (troy_tpu/app/linear.py:43): out[x, y] =
    sum_i ct[x, i] (*) pt[i, y], (*) the multiply_plain product in the NTT
    domain (kernel P1). ct_tiles (X, I, s, k, n); pt_tiles (I, Y, n) mod t
    when pt_mod_t (lifted and transformed here, G' and A), else (I, Y, k, n)
    in NTT form. ct_coeff: the tiles come (and leave) in coefficient form
    (BFV, coefficient-form BGV), transformed here (A)."""
    with profiling.span("tiles_cipher_ntt"):
        ct_ntt = dntt.rns_ntt_forward(ct_tiles, cd.ntt) if ct_coeff \
            else ct_tiles
    w_ntt = _lift_plain_tiles(pt_tiles, cd) if pt_mod_t else pt_tiles
    with profiling.span("tiles_contract"):
        acc = dtiles.tile_contract(ct_ntt, w_ntt, cd.ntt)
    with profiling.span("tiles_inverse_ntt"):
        return dntt.rns_ntt_inverse(acc, cd.ntt) if ct_coeff else acc


# builds and hits of prepared plaintext grids (``_prepared_plain``), always
# counted, as the kernel binding counts its launches
_prepared_count = {"builds": 0, "hits": 0}


def prepared_counts() -> Dict[str, int]:
    """How many contractions built a Plain2d's prepared grid ("builds")
    and how many found it kept ("hits"), since the last reset."""
    return dict(_prepared_count)


def reset_prepared_counts() -> None:
    _prepared_count["builds"] = _prepared_count["hits"] = 0


class _Prepared(NamedTuple):
    """A Plain2d's kept grid (``_prepared_plain``) and what it was built
    from."""
    cd: ContextData
    key: tuple
    tiles: tuple
    ids: tuple
    tensor: torch.Tensor


def _prepared_plain(pt2d: "Plain2d", cd: ContextData,
                    transpose: bool) -> torch.Tensor:
    """The plaintext grid as the contraction takes it: stacked (rows, cols,
    ...), or (cols, rows, ...) with ``transpose``, and mod-t tiles lifted
    and transformed at ``cd``'s level (``_lift_plain_tiles``); NTT-form
    tiles are stacked only. Built on the Plain2d's first contraction and
    kept on it, one entry a Plain2d, keyed by the level's ContextData
    (which fixes the device, ``cd.device``), the layout and the grid's row
    lengths; a hit also needs every tile to be the Plaintext object the
    entry was built from (Plaintext is frozen, so the same object holds
    the same tensor), else the entry is rebuilt
    (``Evaluator._prepermuted_key``'s check). The entry holds the tiles it
    was built from, so no live object can take one of their ids."""
    grid = pt2d.data
    key = (transpose, tuple(map(len, grid)))
    ids = tuple(map(id, itertools.chain.from_iterable(grid)))
    kept = pt2d._prepared
    if kept is not None and kept.cd is cd and kept.key == key \
            and kept.ids == ids:
        _prepared_count["hits"] += 1
        return kept.tensor
    pt2d._prepared = None               # the old tensor's memory goes first
    tiles = tuple(itertools.chain.from_iterable(grid))
    with profiling.span("tiles_stack"):
        tensor = _stack_grid(grid, transpose)
    if not tiles[0].is_ntt_form:
        tensor = _lift_plain_tiles(tensor, cd)
    pt2d._prepared = _Prepared(cd, key, tiles, ids, tensor)
    _prepared_count["builds"] += 1
    return tensor


def _matmul_cipher_tiles_core(a_tiles: torch.Tensor, w_tiles: torch.Tensor,
                              cd: ContextData) -> torch.Tensor:
    """The ct x ct tile contraction (troy_tpu/app/linear.py:153) out[x, y] =
    sum_i mult(a[x, i], w[i, y]), each product as the evaluator's multiply
    gives it, summed in the JAX package's order. a_tiles (I, X, s1, k, n),
    the inner index first; w_tiles (I, Yc, s2, k, n). BFV lifts and
    transforms every tile once (``_bfv_lift_ntt``, span
    ``tiles_cipher_lift``); each inner index is one ``_pair_grid_multiply``
    and one D add (span ``tiles_pair_multiply``, over all of them)."""
    I, X = a_tiles.shape[:2]
    a_rows, w_rows = a_tiles, w_tiles
    if cd.scheme == SchemeType.bfv:
        with profiling.span("tiles_cipher_lift"):
            rows = _bfv_lift_ntt(torch.cat([a_tiles.flatten(0, 1),
                                            w_tiles.flatten(0, 1)]), cd)
        a_rows = rows[:I * X].unflatten(0, (I, X))
        w_rows = rows[I * X:].unflatten(0, (I, w_tiles.shape[1]))
    acc = None
    with profiling.span("tiles_pair_multiply"):
        for i in range(I):
            prod = _pair_grid_multiply(a_rows[i], w_rows[i], cd)
            acc = prod if acc is None else dpoly.rns_add(acc, prod, cd.ntt)
    return acc


def _grid(template: Ciphertext, out: torch.Tensor, **meta) -> "Cipher2d":
    return Cipher2d([[template.replace(data=out[x, y], seed=0, **meta)
                      for y in range(out.shape[1])]
                     for x in range(out.shape[0])])


def _run_cipher_contraction(ev: Evaluator, a2d: "Cipher2d", w2d: "Cipher2d",
                            transpose_w: bool) -> "Cipher2d":
    """Stack two ciphertext grids and contract ct x ct on the device
    (troy_tpu/app/linear.py:171). The outputs take scale a w (CKKS) and
    correction factor a w mod t (BGV)."""
    template, w0 = a2d.data[0][0], w2d.data[0][0]
    if w0.level != template.level:
        raise ValueError("ciphertext level mismatch")
    cd = ev.context.get_context_data(template.level)
    with profiling.span("tiles_stack"):
        a_tiles = _stack_grid(a2d.data, transpose=True)
        w_tiles = _stack_grid(w2d.data, transpose_w)
    out = _matmul_cipher_tiles_core(a_tiles, w_tiles, cd)
    scale = template.scale * w0.scale \
        if cd.scheme == SchemeType.ckks else template.scale
    corr = template.correction_factor * w0.correction_factor \
        % int(cd.plain_modulus) if cd.scheme == SchemeType.bgv else 1
    return _grid(template, out, scale=scale, correction_factor=corr)


def _run_tile_contraction(ev: Evaluator, ct2d: "Cipher2d", pt2d: "Plain2d",
                          transpose_ct: bool, transpose_pt: bool,
                          transpose_out: bool,
                          rows: Optional[range] = None) -> "Cipher2d":
    """Stack a ciphertext grid, take the plaintext grid's prepared form
    (``_prepared_plain``), contract on the device and unpack
    (troy_tpu/app/linear.py:196). The outputs take the plain's
    scale only when it is in NTT form. ``rows``: contract only these rows
    of the untransposed ciphertext grid, the batch-block tiles of one rank
    (parallel/sharding.py sharded_app_matmul, the JAX package's
    ``ct_sharding``); the result holds their output rows."""
    if rows is not None and transpose_ct:
        raise ValueError("rows of a transposed ciphertext grid")
    template, pt0 = ct2d.data[0][0], pt2d.data[0][0]
    if pt0.is_ntt_form and pt0.level != template.level:
        raise ValueError("NTT-form plaintext level mismatch")
    cd = ev.context.get_context_data(template.level)
    grid = ct2d.data if rows is None else ct2d.data[rows.start:rows.stop]
    with profiling.span("tiles_stack"):
        ct_tiles = _stack_grid(grid, transpose_ct)
    pt_tiles = _prepared_plain(pt2d, cd, transpose_pt)
    out = _matmul_tiles_core(ct_tiles, pt_tiles, cd,
                             not template.is_ntt_form, False)
    with profiling.span("tiles_unpack"):
        if transpose_out:
            out = out.transpose(0, 1).contiguous()
        scale = template.scale * pt0.scale if pt0.is_ntt_form \
            else template.scale
        return _grid(template, out, scale=scale)


def _pack_outputs_core(ev: Evaluator, data: torch.Tensor, steps,
                       cd: ContextData, pre_shift: int, mul: int,
                       pack_slots: int, ntt_domain: bool) -> torch.Tensor:
    """The packOutputs pipeline (troy_tpu/app/linear.py:255,
    LinearHelper.cuh:592-650) over all the output ciphertexts (m, 2, k, n):
    the pre-shift (one N1 launch), every coefficient times n^-1 mul (one D
    launch; troy_tpu/evaluator.py:624 fuses it into the trace), the field
    trace (one batched fold and one D add per step) and the fold of each
    group of pack_slots traces into one (kernel P3): (ceil(m / pack_slots),
    2, k, n). Spans: ``pack_prepare`` (the shift and the scale), the
    trace's ``field_trace`` and ``pack_group_fold``."""
    with profiling.span("pack_prepare"):
        if pre_shift:
            data = dpoly.negacyclic_shift(data, pre_shift, cd.ntt)
        if mul:
            data = dpoly.rns_scalar_mul(
                data, [numth.invert_mod(cd.n, q) * mul % q
                       for q in cd.coeff_values], cd.ntt)
    data = ev._trace(data, steps, cd, ntt_domain)
    with profiling.span("pack_group_fold"):
        return dtiles.pack_group_fold(data, pack_slots, cd.ntt)


def _blobs(raw: bytes):
    """The length-prefixed blobs of a stream, in order."""
    off = 0
    while off < len(raw):
        ln, = _struct.unpack("<Q", raw[off:off + 8])
        yield raw[off + 8:off + 8 + ln]
        off += 8 + ln


def _with_lengths(blobs) -> bytes:
    return b"".join(_struct.pack("<Q", len(b)) + b for b in blobs)


class Plain2d:
    """(LinearHelper.cuh:21). A contraction keeps the grid's prepared form
    on it (``_prepared_plain``): a tile replaced in ``data`` is seen at the
    next contraction; a tile's tensor changed in place is not."""

    def __init__(self, data: Optional[List[List[Plaintext]]] = None):
        self.data: List[List[Plaintext]] = data if data is not None else []
        self._prepared = None

    def __getitem__(self, i):
        return self.data[i]

    def encrypt(self, encryptor: Encryptor) -> "Cipher2d":
        return Cipher2d([[encryptor.encrypt(p) for p in row]
                         for row in self.data])

    def encrypt_symmetric(self, encryptor: Encryptor,
                          save_seed: bool = False) -> "Cipher2d":
        """Every tile in one batched encryption (encrypt_symmetric_many)."""
        flat = [p for row in self.data for p in row]
        cts = encryptor.encrypt_symmetric_many(flat, save_seed)
        out, i = [], 0
        for row in self.data:
            out.append(cts[i:i + len(row)])
            i += len(row)
        return Cipher2d(out)


class Cipher2d:
    """(LinearHelper.cuh:42)"""

    def __init__(self, data: Optional[List[List[Ciphertext]]] = None):
        self.data: List[List[Ciphertext]] = data if data is not None else []

    def __getitem__(self, i):
        return self.data[i]

    def save(self, context: Optional[HeContext] = None) -> bytes:
        """Rows, columns, then each tile's TCT1 blob; the tiles' words come
        to the host in one copy when all share a shape."""
        rows = len(self.data)
        cols = len(self.data[0]) if rows else 0
        if any(len(row) != cols for row in self.data):
            raise ValueError("not rectangular")
        flat = [ct for row in self.data for ct in row]
        hosts = ser.fetch_ciphertexts_host(flat, context) \
            if all(c.data.shape == flat[0].data.shape for c in flat) \
            else [None] * len(flat)
        return _struct.pack("<QQ", rows, cols) + _with_lengths(
            ser.save_ciphertext(ct, host_data=h) for ct, h in zip(flat, hosts))

    @classmethod
    def load(cls, raw: bytes, context: HeContext) -> "Cipher2d":
        rows, cols = _struct.unpack("<QQ", raw[:16])
        blobs = _blobs(raw[16:])
        return cls([[ser.load_ciphertext(next(blobs), context)
                     for _ in range(cols)] for _ in range(rows)])

    def _each(self, fn) -> "Cipher2d":
        return Cipher2d([[fn(c) for c in row] for row in self.data])

    def mod_switch_to_next(self, ev: Evaluator) -> "Cipher2d":
        return self._each(ev.mod_switch_to_next)

    def relinearize(self, ev: Evaluator, rlk: RelinKeys) -> "Cipher2d":
        return self._each(lambda c: ev.relinearize(c, rlk))

    def add(self, ev: Evaluator, other: "Cipher2d") -> "Cipher2d":
        return Cipher2d([[ev.add(a, b) for a, b in zip(r1, r2)]
                         for r1, r2 in zip(self.data, other.data)])

    def add_plain(self, ev: Evaluator, other: Plain2d) -> "Cipher2d":
        return Cipher2d([[ev.add_plain(a, b) for a, b in zip(r1, r2)]
                         for r1, r2 in zip(self.data, other.data)])

    def switch_key(self, ev: Evaluator, ksk) -> "Cipher2d":
        """Re-key every ciphertext (LinearHelper.cuh:124 switch_key)."""
        return self._each(lambda c: ev.apply_keyswitching(c, ksk))

    def multiply_scalar(self, ev: Evaluator,
                        encode_poly: Callable[[np.ndarray], Plaintext],
                        scalar: int) -> "Cipher2d":
        """Every ciphertext times the constant polynomial [scalar]
        (LinearHelper.cuh:134 multiplyScalarInplace)."""
        p = encode_poly(np.array([scalar], dtype=np.uint64))
        return self._each(lambda c: ev.multiply_plain(c, p))


class MatmulHelper:
    """Coefficient-packed batched matmul (LinearHelper.cuh:228).

    objective 0: encrypt inputs; 1: encrypt weights; 2: weight gradient.
    pack_lwe enables the field-trace output packing (packOutputs).
    """

    def __init__(self, batch_size: int, input_dims: int, output_dims: int,
                 slot_count: int, objective: int = 0, pack_lwe: bool = True):
        self.batch_size = batch_size
        self.input_dims = input_dims
        self.output_dims = output_dims
        self.slot_count = slot_count
        self.objective = objective
        self.pack_lwe = pack_lwe
        self._determine_block()

    # ---- tiling search (LinearHelper.cuh:242-307) ----
    def _determine_block(self):
        bs, ind, outd, slots = (self.batch_size, self.input_dims,
                                self.output_dims, self.slot_count)
        best = (0, 0, 0)
        c_best = 2 ** 31 - 1
        if not self.pack_lwe:
            for b in range(bs, 0, -1):
                bc = ceil_div(bs, b)
                if b >= slots:
                    continue
                if bc * 2 > c_best:
                    continue
                for i in range(1, slots // b):
                    o = min(slots // b // i, outd)
                    if i > ind or o < 1:
                        continue
                    if self.objective == 0:
                        c = bc * (ceil_div(ind, i) + ceil_div(outd, o))
                    elif self.objective == 1:
                        c = (bc + ceil_div(ind, i)) * ceil_div(outd, o)
                    elif self.objective == 2:
                        c = bc * ind + (bc + ceil_div(ind, i)) * ceil_div(outd, o)
                    else:
                        raise ValueError("invalid objective")
                    if c < c_best:
                        best, c_best = (b, i, o), c
        else:
            # pow(slotCount, 0.33), not an exact cube root, as the
            # reference (LinearHelper.cuh:271): the same blocks, so the same
            # ciphertext counts
            cube = slots ** 0.33
            i = 1
            while i * 2 < cube:
                i *= 2
            if i > ind:
                i = 1
                while i < ind:
                    i *= 2
            for b in range(1, bs + 1):
                bc = ceil_div(bs, b)
                if b > slots:
                    continue
                o = min(slots // b // i, outd)
                if o < 1:
                    continue
                if self.objective == 0:
                    c = bc * ceil_div(ind, i) + ceil_div(bc * ceil_div(outd, o), i)
                elif self.objective == 1:
                    c = (ceil_div(outd, o) * ceil_div(ind, i)
                         + ceil_div(bc * ceil_div(outd, o), i))
                elif self.objective == 2:
                    c = (bc * ceil_div(ind, i)
                         + ceil_div(outd, o) * ceil_div(ind, i)
                         + ceil_div(bc * ceil_div(outd, o), i))
                else:
                    raise ValueError("invalid objective")
                if c < c_best:
                    best, c_best = (b, i, o), c
        self.batch_block, self.input_block, self.output_block = best
        if self.batch_block == 0:
            raise ValueError("no feasible tiling for these dimensions")

    def _blocks(self):
        """(di, dj, li, ui, lj, uj) of every output block, row-major."""
        for di, li in enumerate(range(0, self.batch_size, self.batch_block)):
            ui = min(li + self.batch_block, self.batch_size)
            for dj, lj in enumerate(range(0, self.output_dims,
                                          self.output_block)):
                yield di, dj, li, ui, lj, min(lj + self.output_block,
                                              self.output_dims)

    def _packed_count(self) -> int:
        return ceil_div(ceil_div(self.batch_size, self.batch_block)
                        * ceil_div(self.output_dims, self.output_block),
                        self.input_block)

    # ---- encoders (LinearHelper.cuh:309-401) ----
    @profiling.spanned("encode")
    def encode_weights(self, encode_poly: Callable[[np.ndarray], Plaintext],
                       weights: np.ndarray) -> Plain2d:
        """weights: (input_dims, output_dims). Blocks hold reversed input
        coefficients, so the polynomial product lines up the dot products:
        vec[(j - lj) h + h - 1 - (i - li)] = W[i, j]."""
        h, w = self.input_block, self.output_block
        weights = np.asarray(weights)
        rows = []
        for li in range(0, self.input_dims, h):
            ui = min(li + h, self.input_dims)
            row = []
            for lj in range(0, self.output_dims, w):
                uj = min(lj + w, self.output_dims)
                vec = np.zeros(h * w, dtype=weights.dtype)
                sub = np.zeros((uj - lj, h), dtype=weights.dtype)
                sub[:, h - (ui - li):] = weights[li:ui, lj:uj][::-1, :].T
                vec[:(uj - lj) * h] = sub.reshape(-1)
                row.append(encode_poly(vec))
            rows.append(row)
        return Plain2d(rows)

    @profiling.spanned("encode")
    def encode_inputs(self, encode_poly: Callable[[np.ndarray], Plaintext],
                      inputs: np.ndarray) -> Plain2d:
        """inputs: (batch_size, input_dims)."""
        iB, oB = self.input_block, self.output_block
        inputs = np.asarray(inputs)
        rows = []
        for li in range(0, self.batch_size, self.batch_block):
            ui = min(li + self.batch_block, self.batch_size)
            row = []
            for lj in range(0, self.input_dims, iB):
                uj = min(lj + iB, self.input_dims)
                vec = np.zeros(self.slot_count, dtype=inputs.dtype)
                blk = vec[:(ui - li) * iB * oB].reshape(ui - li, iB * oB)
                blk[:, :uj - lj] = inputs[li:ui, lj:uj]
                row.append(encode_poly(vec))
            rows.append(row)
        return Plain2d(rows)

    def encrypt_inputs(self, encryptor: Encryptor,
                       encode_poly, inputs) -> Cipher2d:
        """Symmetric, as the reference's Plain2d::encrypt
        (LinearHelper.cuh:208-215 encryptSymmetric)."""
        return self.encode_inputs(encode_poly,
                                  inputs).encrypt_symmetric(encryptor)

    # ---- the matmul itself (LinearHelper.cuh:403-479) ----
    @profiling.spanned("matmul")
    def matmul(self, ev: Evaluator, a: Cipher2d, w: Plain2d) -> Cipher2d:
        """out[b, j] = sum_i a[b, i] (*) w[i, j], every tile in one
        contraction (LinearHelper.cuh:403-427)."""
        return _run_tile_contraction(ev, a, w, transpose_ct=False,
                                     transpose_pt=False, transpose_out=False)

    @profiling.spanned("matmul_cipher")
    def matmul_cipher(self, ev: Evaluator, a: Cipher2d,
                      w: Cipher2d) -> Cipher2d:
        """ct x ct matmul (LinearHelper.cuh:429): size-3 outputs
        (relinearize afterwards if needed)."""
        return _run_cipher_contraction(ev, a, w, transpose_w=False)

    def matmul_reverse(self, ev: Evaluator, a: Plain2d,
                       w: Cipher2d) -> Cipher2d:
        """Encrypted weights, plain inputs: out[b, j] = sum_i w[i, j] (*)
        a[b, i], the ciphertext grid transposed to (j, i) and the output
        back."""
        return _run_tile_contraction(ev, w, a, transpose_ct=True,
                                     transpose_pt=True, transpose_out=True)

    # ---- output positions ----
    def _positions(self, rows: int, cols: int, offset: int) -> np.ndarray:
        """(rows, cols) coefficient indices of a block's outputs: i iB oB +
        j iB + offset."""
        iB, oB = self.input_block, self.output_block
        return (np.arange(rows)[:, None] * (iB * oB)
                + np.arange(cols)[None, :] * iB + offset)

    def decrypt_outputs(self, decode_poly: Callable[[Plaintext], np.ndarray],
                        decryptor: Decryptor, outputs: Cipher2d) -> np.ndarray:
        """(LinearHelper.cuh:540-591 decryptOutputs): one batched
        decryption, then numpy gathers of each block's coefficients."""
        iB = self.input_block
        dec = np.zeros((self.batch_size, self.output_dims), dtype=np.object_)
        if not self.pack_lwe:
            flat = [ct for row in outputs.data for ct in row]
            bufs = [decode_poly(p) for p in decryptor.decrypt_many(flat)]
            cols = len(outputs.data[0])
            for di, dj, li, ui, lj, uj in self._blocks():
                buf = bufs[di * cols + dj]
                dec[li:ui, lj:uj] = buf[self._positions(ui - li, uj - lj,
                                                        iB - 1)]
        else:
            bufs = [decode_poly(p)
                    for p in decryptor.decrypt_many(outputs[0])]
            ob_count = ceil_div(self.output_dims, self.output_block)
            for di, dj, li, ui, lj, uj in self._blocks():
                packed_id, packed_off = divmod(di * ob_count + dj, iB)
                dec[li:ui, lj:uj] = bufs[packed_id][
                    self._positions(ui - li, uj - lj, packed_off)]
        return dec

    def encode_outputs(self, encode_poly: Callable[[np.ndarray], Plaintext],
                       outputs: np.ndarray) -> Plain2d:
        """An output matrix (batch_size, output_dims) in the packed layout
        the matmul produces, for the server to add or subtract masks
        (LinearHelper.cuh:481-560 encodeOutputs)."""
        outputs = np.asarray(outputs)
        iB = self.input_block
        if not self.pack_lwe:
            grid = {}
            for di, dj, li, ui, lj, uj in self._blocks():
                vec = np.zeros(self.slot_count, dtype=outputs.dtype)
                vec[self._positions(ui - li, uj - lj, iB - 1)] = \
                    outputs[li:ui, lj:uj]
                grid.setdefault(di, []).append(encode_poly(vec))
            return Plain2d([grid[di] for di in sorted(grid)])
        ob_count = ceil_div(self.output_dims, self.output_block)
        bufs = [np.zeros(self.slot_count, dtype=outputs.dtype)
                for _ in range(self._packed_count())]
        for di, dj, li, ui, lj, uj in self._blocks():
            packed_id, packed_off = divmod(di * ob_count + dj, iB)
            bufs[packed_id][self._positions(ui - li, uj - lj, packed_off)] = \
                outputs[li:ui, lj:uj]
        return Plain2d([[encode_poly(b) for b in bufs]])

    # ---- encoded-weight serialization (LinearHelper.cuh:652-684) ----
    def serialize_encoded_weights(self, w: Plain2d) -> bytes:
        rows = len(w.data)
        cols = len(w.data[0]) if rows else 0
        if rows == 0 or cols == 0:
            raise ValueError("empty weight matrix")
        if any(len(row) != cols for row in w.data):
            raise ValueError("weight matrix is not rectangular")
        return _struct.pack("<QQ", rows, cols) + _with_lengths(
            ser.save_plaintext(pt) for row in w.data for pt in row)

    @staticmethod
    def deserialize_encoded_weights(raw: bytes,
                                    device=DEFAULT_DEVICE) -> Plain2d:
        rows, cols = _struct.unpack("<QQ", raw[:16])
        blobs = _blobs(raw[16:])
        return Plain2d([[ser.load_plaintext(next(blobs), device)
                         for _ in range(cols)] for _ in range(rows)])

    # ---- LWE-trace packing (LinearHelper.cuh:592-650 packOutputs) ----
    @profiling.spanned("pack_outputs")
    def pack_outputs(self, ev: Evaluator, auto_keys: GaloisKeys,
                     cipher: Cipher2d) -> Cipher2d:
        """Every group of input_block output ciphertexts packed into one:
        shifted, traced down to degree n / input_block (the automorphism
        keys of elements n + 1, n/2 + 1, ...) and folded
        (``_pack_outputs_core``). The outputs must be in coefficient form
        when input_block > 1 (the shift)."""
        if not self.pack_lwe:
            raise ValueError("pack_lwe not enabled")
        if not cipher.data or not cipher.data[0]:
            return Cipher2d([[]])
        pack_slots = self.input_block
        n = self.slot_count
        field_trace_logn = 0
        ftn = 1
        while ftn != n // pack_slots:
            field_trace_logn += 1
            ftn *= 2
        flat = [ct for row in cipher.data for ct in row]
        ntt_domain = flat[0].is_ntt_form
        if ntt_domain and pack_slots > 1:
            raise ValueError("negacyclic shift expects coefficient form")
        steps = ev._field_trace_steps(auto_keys, field_trace_logn)
        cd = ev.context.get_context_data(flat[0].level)
        pre_shift = (2 * n - (pack_slots - 1)) if pack_slots > 1 else 0
        packed = _pack_outputs_core(ev, torch.stack([ct.data for ct in flat]),
                                    steps, cd, pre_shift, n // pack_slots,
                                    pack_slots, ntt_domain)
        return Cipher2d([[flat[0].replace(data=packed[g], seed=0)
                          for g in range(packed.shape[0])]])

    # ---- serialization (LinearHelper.cuh:686-750) ----
    def serialize_outputs(self, ev: Evaluator, context: HeContext,
                          x: Cipher2d) -> bytes:
        """Without packing, only each block's output coefficients of c0
        (save_terms, after one batched inverse NTT and one copy); with it,
        the packed ciphertexts whole."""
        if not self.pack_lwe:
            flat = [ct for row in x.data for ct in row]
            hosts = ser.fetch_ciphertexts_host(flat, context, to_coeff=True)
            blobs = []
            for (di, dj, li, ui, lj, uj), h in zip(self._blocks(), hosts):
                required = self._positions(ui - li, uj - lj,
                                           self.input_block - 1).reshape(-1)
                blobs.append(ser.save_terms(x[di][dj], context, required,
                                            host_coeff_data=h))
            return _with_lengths(blobs)
        if self._packed_count() != len(x.data[0]):
            raise ValueError("output ciphertext count incorrect")
        hosts = ser.fetch_ciphertexts_host(x[0], context)
        return _with_lengths(ser.save_ciphertext(ct, host_data=h)
                             for ct, h in zip(x[0], hosts))

    def deserialize_outputs(self, ev: Evaluator, context: HeContext,
                            raw: bytes) -> Cipher2d:
        blobs = _blobs(raw)
        if not self.pack_lwe:
            rows = {}
            for di, dj, li, ui, lj, uj in self._blocks():
                required = self._positions(ui - li, uj - lj,
                                           self.input_block - 1).reshape(-1)
                rows.setdefault(di, []).append(
                    ser.load_terms(next(blobs), context, required))
            return Cipher2d([rows[di] for di in sorted(rows)])
        return Cipher2d([[ser.load_ciphertext(next(blobs), context)
                          for _ in range(self._packed_count())]])


class Conv2dHelper:
    """Coefficient-packed 2-D convolution (LinearHelper.cuh:753-1195)."""

    def __init__(self, batch_size: int, image_height: int, image_width: int,
                 kernel_height: int, kernel_width: int, input_channels: int,
                 output_channels: int, slot_count: int, objective: int = 0):
        self.batch_size = batch_size
        self.image_height = image_height
        self.image_width = image_width
        self.kernel_height = kernel_height
        self.kernel_width = kernel_width
        self.input_channels = input_channels
        self.output_channels = output_channels
        self.slot_count = slot_count
        self.objective = objective
        self._determine_block()

    def _determine_block(self):
        bs, H, W = self.batch_size, self.image_height, self.image_width
        kh, kw = self.kernel_height, self.kernel_width
        ci_all, co_all, slots = (self.input_channels, self.output_channels,
                                 self.slot_count)
        best = None
        c_best = 2 ** 31 - 1
        for b in range(bs, 0, -1):
            for h in range(min(H, slots // b), kh - 1, -1):
                for w in range(min(W, slots // b // h), kw - 1, -1):
                    for co in range(min(co_all, slots // b // h // w), 0, -1):
                        ci = min(slots // b // h // w // co, ci_all)
                        if ci == 0:
                            continue
                        blocks = (ceil_div(bs, b)
                                  * ceil_div(H - kh + 1, h - kh + 1)
                                  * ceil_div(W - kw + 1, w - kw + 1))
                        in_sz = blocks * ceil_div(ci_all, ci)
                        out_sz = blocks * ceil_div(co_all, co)
                        w_sz = ceil_div(ci_all, ci) * ceil_div(co_all, co)
                        if self.objective == 0:
                            c = in_sz + out_sz
                        elif self.objective == 1:
                            c = w_sz + out_sz
                        elif self.objective == 2:
                            c = in_sz + out_sz + w_sz
                        else:
                            raise ValueError("invalid objective")
                        if c < c_best:
                            c_best = c
                            best = (b, h, w, ci, co)
        if best is None:
            raise ValueError("no feasible conv tiling")
        (self.block_batch, self.block_height, self.block_width,
         self.block_in_channels, self.block_out_channels) = best

    def total_batch_size(self) -> int:
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        sh = ceil_div(self.image_height - kh, self.block_height - kh)
        sw = ceil_div(self.image_width - kw, self.block_width - kw)
        return ceil_div(self.batch_size, self.block_batch) * sh * sw

    @profiling.spanned("encode")
    def encode_weights(self, encode_poly, weights: np.ndarray) -> Plain2d:
        """weights: (out_channels, in_channels, kh, kw), each kernel flipped
        into its reversed-channel block (LinearHelper.cuh:866-903)."""
        weights = np.asarray(weights)
        kh, kw = self.kernel_height, self.kernel_width
        bw = self.block_width
        bci, bco = self.block_in_channels, self.block_out_channels
        block = self.block_height * bw
        rows = []
        for loc in range(0, self.output_channels, bco):
            uoc = min(loc + bco, self.output_channels)
            row = []
            for lic in range(0, self.input_channels, bci):
                uic = min(lic + bci, self.input_channels)
                spread = np.zeros((bco, bci, self.block_height, bw),
                                  dtype=weights.dtype)
                # channel ic lands at bci - 1 - (ic - lic)
                spread[:uoc - loc, bci - (uic - lic):, :kh, :kw] = \
                    weights[loc:uoc, lic:uic, ::-1, ::-1][:, ::-1]
                row.append(encode_poly(spread.reshape(bci * bco * block)))
            rows.append(row)
        return Plain2d(rows)

    def _patch_ranges(self):
        """(lb, ub, si, sj, ui, uj) of every input block, in order."""
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        bh, bw = self.block_height, self.block_width
        sh = ceil_div(self.image_height - kh, bh - kh)
        sw = ceil_div(self.image_width - kw, bw - kw)
        for lb in range(0, self.batch_size, self.block_batch):
            ub = min(lb + self.block_batch, self.batch_size)
            for ih in range(sh):
                for iw in range(sw):
                    si, sj = ih * (bh - kh), iw * (bw - kw)
                    yield (lb, ub, si, sj, min(si + bh, self.image_height),
                           min(sj + bw, self.image_width))

    @profiling.spanned("encode")
    def encode_inputs(self, encode_poly, inputs: np.ndarray) -> Plain2d:
        """inputs: (batch, in_channels, H, W) (LinearHelper.cuh:918-966)."""
        inputs = np.asarray(inputs)
        bh, bw = self.block_height, self.block_width
        bci, bco = self.block_in_channels, self.block_out_channels
        rows = []
        for lb, ub, si, sj, ui, uj in self._patch_ranges():
            group = []
            for lci in range(0, self.input_channels, bci):
                uci = min(lci + bci, self.input_channels)
                vec = np.zeros(self.slot_count, dtype=inputs.dtype)
                # batch b, channel c at (b bci bco + c) bh bw
                blocks = vec[:self.block_batch * bci * bco * bh * bw] \
                    .reshape(self.block_batch, bci * bco, bh, bw)
                blocks[:ub - lb, :uci - lci, :ui - si, :uj - sj] = \
                    inputs[lb:ub, lci:uci, si:ui, sj:uj]
                group.append(encode_poly(vec))
            rows.append(group)
        return Plain2d(rows)

    def encrypt_inputs(self, encryptor: Encryptor, encode_poly,
                       inputs) -> Cipher2d:
        """Symmetric, as the reference (LinearHelper.cuh:208-215)."""
        return self.encode_inputs(encode_poly,
                                  inputs).encrypt_symmetric(encryptor)

    @profiling.spanned("conv2d")
    def conv2d(self, ev: Evaluator, a: Cipher2d, w: Plain2d) -> Cipher2d:
        """out[b, oc] = sum_i a[b, i] (*) w[oc, i]: one contraction over
        every (batch x out-channel group x in-channel) tile
        (LinearHelper.cuh Conv2dHelper::conv2d)."""
        return _run_tile_contraction(ev, a, w, transpose_ct=False,
                                     transpose_pt=True, transpose_out=False)

    def conv2d_cipher(self, ev: Evaluator, a: Cipher2d,
                      w: Cipher2d) -> Cipher2d:
        """ct x ct convolution: out[b, oc] = sum_i mult(a[b, i], w[oc, i])
        (w taken in the (i, oc) layout)."""
        return _run_cipher_contraction(ev, a, w, transpose_w=True)

    def conv2d_reverse(self, ev: Evaluator, a: Plain2d,
                       w: Cipher2d) -> Cipher2d:
        """Encrypted weights, plain inputs: out[b, oc] = sum_i w[oc, i] (*)
        a[b, i] (LinearHelper.cuh:1020-1043 conv2dReverse): the weight grid
        (oc, i) against the input grid transposed to (i, b), the (oc, b)
        result transposed back."""
        return _run_tile_contraction(ev, w, a, transpose_ct=False,
                                     transpose_pt=True, transpose_out=True)

    def _mask_index(self, b, c, i, j, yh, yw):
        bci, bco = self.block_in_channels, self.block_out_channels
        interval = self.block_height * self.block_width
        return ((b * bci * bco + c * bci + bci - 1) * interval
                + (self.block_height - yh + i) * self.block_width
                + (self.block_width - yw + j))

    def _output_blocks(self):
        """(eb, group, lb, ub, lc, uc, the (b, c, i, j) coefficient index
        array, the output slices) of every output ciphertext."""
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        yh, yw = self.block_height - kh, self.block_width - kw
        oyh, oyw = self.image_height - kh, self.image_width - kw
        sh, sw = ceil_div(oyh, yh), ceil_div(oyw, yw)
        bco = self.block_out_channels
        for eb in range(self.total_batch_size()):
            si, sj = (eb % (sh * sw)) // sw, eb % sw
            lb = (eb // (sh * sw)) * self.block_batch
            ub = min(lb + self.block_batch, self.batch_size)
            vh, vw = min(yh, oyh - si * yh), min(yw, oyw - sj * yw)
            for g, lc in enumerate(range(0, self.output_channels, bco)):
                uc = min(lc + bco, self.output_channels)
                idx = self._mask_index(
                    np.arange(ub - lb)[:, None, None, None],
                    np.arange(uc - lc)[None, :, None, None],
                    np.arange(vh)[None, None, :, None],
                    np.arange(vw)[None, None, None, :], yh, yw)
                yield eb, g, idx, (slice(lb, ub), slice(lc, uc),
                                   slice(si * yh, si * yh + vh),
                                   slice(sj * yw, sj * yw + vw))

    def decrypt_outputs(self, decode_poly, decryptor: Decryptor,
                        outputs: Cipher2d) -> np.ndarray:
        """(batch, out_channels, H-kh+1, W-kw+1), from one batched
        decryption and numpy gathers (LinearHelper.cuh:1090-1135)."""
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        ret = np.zeros((self.batch_size, self.output_channels,
                        self.image_height - kh, self.image_width - kw),
                       dtype=np.object_)
        groups = ceil_div(self.output_channels, self.block_out_channels)
        flat = [outputs[eb][g] for eb in range(self.total_batch_size())
                for g in range(groups)]
        bufs = [decode_poly(p) for p in decryptor.decrypt_many(flat)]
        for eb, g, idx, out in self._output_blocks():
            ret[out] = bufs[eb * groups + g][idx]
        return ret

    def encode_outputs(self, encode_poly, outputs: np.ndarray) -> Plain2d:
        """(batch, out_channels, H-kh+1, W-kw+1) outputs in the conv's
        packed layout, for server-side masking (LinearHelper.cuh
        encodeOutputs on Conv2dHelper)."""
        outputs = np.asarray(outputs)
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        if outputs.shape != (self.batch_size, self.output_channels,
                             self.image_height - kh, self.image_width - kw):
            raise ValueError("outputs shape incorrect")
        rows = {}
        for eb, g, idx, out in self._output_blocks():
            vec = np.zeros(self.slot_count, dtype=outputs.dtype)
            vec[idx] = outputs[out]
            rows.setdefault(eb, []).append(encode_poly(vec))
        return Plain2d([rows[eb] for eb in sorted(rows)])

    def _required(self) -> np.ndarray:
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        yh, yw = self.block_height - kh, self.block_width - kw
        return self._mask_index(
            np.arange(self.block_batch)[:, None, None, None],
            np.arange(self.block_out_channels)[None, :, None, None],
            np.arange(yh)[None, None, :, None],
            np.arange(yw)[None, None, None, :], yh, yw).reshape(-1)

    def serialize_outputs(self, ev: Evaluator, context: HeContext,
                          x: Cipher2d) -> bytes:
        required = self._required()
        groups = ceil_div(self.output_channels, self.block_out_channels)
        flat = [x[b][oc] for b in range(self.total_batch_size())
                for oc in range(groups)]
        hosts = ser.fetch_ciphertexts_host(flat, context, to_coeff=True)
        return _with_lengths(
            ser.save_terms(ct, context, required, host_coeff_data=h)
            for ct, h in zip(flat, hosts))

    def deserialize_outputs(self, ev: Evaluator, context: HeContext,
                            raw: bytes) -> Cipher2d:
        required = self._required()
        groups = ceil_div(self.output_channels, self.block_out_channels)
        blobs = _blobs(raw)
        return Cipher2d([[ser.load_terms(next(blobs), context, required)
                          for _ in range(groups)]
                         for _ in range(self.total_batch_size())])
