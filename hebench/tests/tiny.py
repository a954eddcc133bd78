"""Tiny rings of each request kind, for the CPU tests: the cells' request
kinds, traffic and references at n = 256-1024, security none."""

from __future__ import annotations

import copy

from hebench import harness as h
from hebench.reference import bfv

SEAL_LIKE = {"name": "tiny_seal", "scheme": "bfv", "security": "none",
             "poly_modulus_degree": 1024,
             "coeff_modulus": bfv.seal_primes(1024, [55, 55, 55, 56]),
             "plain_modulus": bfv.seal_primes(1024, [20])[0]}
APP_LIKE = {"name": "tiny_app", "scheme": "bfv", "security": "none",
            "poly_modulus_degree": 256,
            "coeff_modulus": bfv.seal_primes(256, [60, 60, 60]),
            "plain_modulus": 1 << 41}

WORKLOADS = {
    "mul_relin": (SEAL_LIKE, {"kind": "mul_relin", "inflight": 2, "pool": 4,
                              "warm": 2, "sample": 3, "fed_chunk": 2,
                              "fed_requests": 5}),
    "conv2d": (APP_LIKE, {"kind": "conv2d", "inflight": 2, "pool": 2,
                          "warm": 1, "sample": 2, "image": [1, 6, 6],
                          "kernel": [3, 3], "channels": [4, 8],
                          "blocks": [1, 6, 6, 2, 3], "input_bound": 256,
                          "fed_chunk": 2, "fed_requests": 3}),
}


def cell(kind: str, per_layer=None, end_to_end=None) -> h.Cell:
    cfg, wl = WORKLOADS[kind]
    wl = dict(copy.deepcopy(wl), config=cfg["name"])
    return h.Cell(f"tiny_{kind}", copy.deepcopy(cfg), wl, 1, per_layer,
                  end_to_end)
