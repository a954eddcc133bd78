"""The app layer's answers and where troy's helpers put them, in NumPy.

The valid 2-D convolution is computed exactly in float64 (entries below
2^8 and sums of at most a few thousand terms stay below 2^53). Where each
answer lies in the coefficients of an output plaintext follows troy's
``LinearHelper.cuh`` (``Conv2dHelper::decryptOutputs``) for the block
sizes the cell's workload file states.

This module imports numpy only.
"""

from __future__ import annotations

import numpy as np


def conv2d(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The valid cross-correlation of x (B, CI, H, W) with w (CO, CI, KH,
    KW) by im2col, as int64, exact."""
    B, CI, H, W = x.shape
    CO, _, KH, KW = w.shape
    oh, ow = H - KH + 1, W - KW + 1
    cols = np.stack([x[:, :, i:i + oh, j:j + ow] for i in range(KH)
                     for j in range(KW)], axis=2)
    cols = cols.reshape(B, CI * KH * KW, oh * ow).astype(np.float64)
    out = np.einsum("ok,bkp->bop", w.reshape(CO, -1).astype(np.float64), cols)
    return out.reshape(B, CO, oh, ow).astype(np.int64)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def conv2d_layout(shape, kernel, channels, blocks) -> list:
    """For a conv2d: a list over the output ciphertexts, row-major over
    (input patch, output-channel group), of (coefficient indices, the
    (b, c, h, w) index arrays of the answer). shape = (B, H, W), kernel =
    (KH, KW), channels = (CI, CO), blocks = (block batch, bh, bw, bci,
    bco); output (b, c, i, j) of a patch lands at ((b bci bco + c bci +
    bci - 1) bh bw + (bh - yh + i) bw + (bw - yw + j)), yh = bh - KH + 1."""
    B, H, W = shape
    KH, KW = kernel
    _, CO = channels
    bb, bh, bw, bci, bco = blocks
    yh, yw = bh - KH + 1, bw - KW + 1
    oyh, oyw = H - KH + 1, W - KW + 1
    sh, sw = ceil_div(oyh, yh), ceil_div(oyw, yw)
    out = []
    for eb in range(ceil_div(B, bb) * sh * sw):
        si, sj = (eb % (sh * sw)) // sw, eb % sw
        lb = (eb // (sh * sw)) * bb
        ub = min(lb + bb, B)
        vh, vw = min(yh, oyh - si * yh), min(yw, oyw - sj * yw)
        for lc in range(0, CO, bco):
            uc = min(lc + bco, CO)
            b, c, i, j = np.meshgrid(np.arange(ub - lb), np.arange(uc - lc),
                                     np.arange(vh), np.arange(vw),
                                     indexing="ij")
            idx = ((b * bci * bco + c * bci + bci - 1) * (bh * bw)
                   + (bh - yh + i) * bw + (bw - yw + j))
            out.append((idx.ravel(), ((b + lb).ravel(), (c + lc).ravel(),
                                      (i + si * yh).ravel(),
                                      (j + sj * yw).ravel())))
    return out
