"""The answer of a ``conv2d`` request: the valid convolution of the
request's input image with the cell's weights, mod t, at the
coefficients where troy's Conv2dHelper puts it."""

from __future__ import annotations

import numpy as np

from . import app


def inputs(cfg: dict, wl: dict, rng: np.random.Generator) -> dict:
    """The pool's images (pool, B, CI, H, W) and the weights (CO, CI, KH,
    KW), uniform below the workload's input bound."""
    (B, H, W), (KH, KW), (CI, CO) = wl["image"], wl["kernel"], wl["channels"]
    bound = wl["input_bound"]
    return {"images": rng.integers(0, bound, (wl["pool"], B, CI, H, W),
                                   dtype=np.uint64),
            "weights": rng.integers(0, bound, (CO, CI, KH, KW),
                                    dtype=np.uint64)}


def draw(wl: dict, rng: np.random.Generator, count: int) -> np.ndarray:
    return rng.integers(0, wl["pool"], (count, 1))


def expected(cfg: dict, wl: dict, data: dict, req) -> list:
    """Per output ciphertext: (coefficient indices, the answers there)."""
    y = app.conv2d(data["images"][req[0]], data["weights"]) % cfg[
        "plain_modulus"]
    layout = app.conv2d_layout(wl["image"], wl["kernel"], wl["channels"],
                               wl["blocks"])
    return [(idx, y[where].astype(np.uint64)) for idx, where in layout]
