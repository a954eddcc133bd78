"""The answer of a ``matmul_cipher`` request: the product x w mod t of the
request's input matrix and weight matrix, at the coefficients of the
packed output ciphertexts where troy's MatmulHelper puts it.

The product is exact in int64: entries below 2^8 and a few hundred terms
stay far below 2^63. The packed layout follows troy's ``LinearHelper.cuh``
(``MatmulHelper::packOutputs`` :592-650 and ``decryptOutputs``), for the
block sizes the cell's workload file states: output block (di, dj), rows
[di bB, ...) and columns [dj oB, ...), goes to packed ciphertext
(di ceil(O / oB) + dj) div iB, its answer (i, j) at coefficient
i iB oB + j iB + ((di ceil(O / oB) + dj) mod iB).

This module imports numpy only.
"""

from __future__ import annotations

import numpy as np

from .app import ceil_div


def inputs(cfg: dict, wl: dict, rng: np.random.Generator) -> dict:
    """The pools: input matrices (pool, B, I) and weight matrices (pool, I,
    O), uniform below the workload's input bound."""
    B, I, O = wl["dims"]
    bound = wl["input_bound"]
    return {"inputs": rng.integers(0, bound, (wl["pool"], B, I),
                                   dtype=np.uint64),
            "weights": rng.integers(0, bound, (wl["pool"], I, O),
                                    dtype=np.uint64)}


def draw(wl: dict, rng: np.random.Generator, count: int) -> np.ndarray:
    """count requests: an input index and a weight index each, drawn
    independently."""
    return rng.integers(0, wl["pool"], (count, 2))


def packed_layout(dims, blocks) -> list:
    """For each packed output ciphertext: (coefficient indices, the (row,
    column) index arrays of the answers there), troy's layout (module
    docstring)."""
    B, _, O = dims
    bB, iB, oB = blocks
    col_blocks = ceil_div(O, oB)
    packed = ceil_div(ceil_div(B, bB) * col_blocks, iB)
    coeffs = [[] for _ in range(packed)]
    rows = [[] for _ in range(packed)]
    cols = [[] for _ in range(packed)]
    for di, li in enumerate(range(0, B, bB)):
        ui = min(li + bB, B)
        for dj, lj in enumerate(range(0, O, oB)):
            uj = min(lj + oB, O)
            pid, off = divmod(di * col_blocks + dj, iB)
            i, j = np.meshgrid(np.arange(ui - li), np.arange(uj - lj),
                               indexing="ij")
            coeffs[pid].append((i * (iB * oB) + j * iB + off).ravel())
            rows[pid].append((i + li).ravel())
            cols[pid].append((j + lj).ravel())
    return [(np.concatenate(c), (np.concatenate(r), np.concatenate(k)))
            for c, r, k in zip(coeffs, rows, cols)]


def expected(cfg: dict, wl: dict, data: dict, req) -> list:
    """Per packed output ciphertext: (coefficient indices, the answers
    there as u64 words)."""
    x = data["inputs"][req[0]].astype(np.int64)
    w = data["weights"][req[1]].astype(np.int64)
    y = (x @ w) % cfg["plain_modulus"]
    return [(idx, y[where].astype(np.uint64))
            for idx, where in packed_layout(wl["dims"], wl["blocks"])]
