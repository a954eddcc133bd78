"""CKKS precision against depth at the headline configuration, on the CPU.

The twin of tests/test_ckks_precision.py: tools/ckks_precision_torch.py
runs the chain of benchmarks/ckks_precision.py (n = 16384,
q = {60,40,40,40,40,60}, scale 2^40, a multiply -> relinearize -> rescale
chain to depth 3, 2 trials) on the port's plain versions, and each row is
held to the JAX package's record, CKKS_PRECISION_r05.json (the same stage
and level, the same precision bits, max_err within 1e-3 of it relative),
and to the JAX test's floors: at least 30 bits fresh, 27 after encrypt,
23 after each multiply + relin and 22 after each rescale, whose level is
one below the multiply's. chip_smoke.py's phase 36 runs the chain on the
card. No JAX.
"""

import json
import pathlib
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RECORD = REPO / "CKKS_PRECISION_r05.json"


# tools/ holds the chain this file shares with chip_smoke.py's phase 36
sys.path.insert(0, str(REPO / "tools"))
import ckks_precision_torch  # noqa: E402


@pytest.fixture(scope="module")
def chain():
    return ckks_precision_torch.run(trials=2, device="cpu")


def test_rows_match_the_jax_record(chain):
    rows, meta = chain
    record = json.loads(RECORD.read_text())
    assert (meta["n"], meta["q_bits"], meta["scale"], meta["trials"],
            meta["depth"]) == tuple(record["meta"][k] for k in (
                "n", "q_bits", "scale", "trials", "depth"))
    assert [r["stage"] for r in rows] == [w["stage"] for w in record["rows"]]
    for r, w in zip(rows, record["rows"]):
        assert r["level"] == w["level"], r["stage"]
        assert r["precision_bits"] == w["precision_bits"], r["stage"]
        assert abs(r["max_err"] - w["max_err"]) <= 1e-3 * w["max_err"], \
            (r["stage"], r["max_err"], w["max_err"])


def test_headline_precision_vs_depth(chain):
    rows, meta = chain
    assert meta["depth"] == 3
    by_stage = {r["stage"]: r for r in rows}
    # the fresh encode: the float64 embedding at scale 2^40
    assert by_stage["encode/decode (fresh)"]["precision_bits"] >= 30.0
    assert by_stage["encrypt/decrypt (fresh)"]["precision_bits"] >= 27.0
    # the chain: each multiply + rescale costs about 1-3 bits
    for d in (1, 2, 3):
        m = by_stage[f"depth {d}: multiply+relin"]
        r = by_stage[f"depth {d}: rescale"]
        assert m["precision_bits"] >= 23.0, (d, m)
        assert r["precision_bits"] >= 22.0, (d, r)
        assert r["level"] == m["level"] + 1
    assert by_stage["depth 3: rescale"]["precision_bits"] >= 22.0
