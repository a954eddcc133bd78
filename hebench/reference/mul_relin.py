"""The answer of a ``mul_relin`` request: a b in Z_t[x]/(x^n + 1)."""

from __future__ import annotations

import numpy as np

from . import bfv


def inputs(cfg: dict, wl: dict, rng: np.random.Generator) -> dict:
    """The pool's messages: coefficient polynomials uniform mod t."""
    n, t = cfg["poly_modulus_degree"], cfg["plain_modulus"]
    return {"messages": rng.integers(0, t, (wl["pool"], n), dtype=np.uint64)}


def draw(wl: dict, rng: np.random.Generator, count: int) -> np.ndarray:
    """count requests: two pool indices each."""
    return rng.integers(0, wl["pool"], (count, 2))


def expected(cfg: dict, wl: dict, data: dict, req) -> list:
    """One output ciphertext, every coefficient compared."""
    m = data["messages"]
    return [(None, bfv.poly_mul_mod(m[req[0]], m[req[1]],
                                    cfg["plain_modulus"]))]
