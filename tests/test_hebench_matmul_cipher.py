"""The benchmark's ct x ct matmul cell (``app_matmul_cipher``: troy's
packed 64x128x256 matmul with both operands encrypted) on the CPU: the
request kind and its reference at a tiny ring, the check that decides
``correct`` against the same faults as the other kinds' and its control,
and the cell's blocks, layout, work counts and configuration at its own
size.

The tiny cell keeps the cell's structure: three 60-bit primes, t = 2^41,
dims whose blocks (8, 4, 8) make an input block above one (so the
pre-shift and two trace steps run) and pack four product ciphertexts
into one output that covers every coefficient.
"""

import copy
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hebench import control, run, work
from hebench import harness as h
from hebench.reference import bfv
from hebench.reference import matmul_cipher as ref
from hebench.requests import matmul_cipher as kind
from hebench.tests import test_hebench_correct as faults

ROOT = Path(__file__).resolve().parent.parent
CELL = "app_matmul_cipher"
TINY_CFG = {"name": "tiny_app_matmul", "scheme": "bfv", "security": "none",
            "poly_modulus_degree": 256,
            "coeff_modulus": bfv.seal_primes(256, [60, 60, 60]),
            "plain_modulus": 1 << 41}
TINY_WL = {"config": "tiny_app_matmul", "kind": "matmul_cipher",
           "inflight": 2, "pool": 2, "warm": 1, "sample": 2,
           "dims": [8, 8, 32], "blocks": [8, 4, 8], "pack_lwe": True,
           "input_bound": 256, "fed_chunk": 2, "fed_requests": 3}

torch.set_num_threads(1)


def tiny_cell(per_layer=None, end_to_end=None) -> h.Cell:
    return h.Cell("tiny_matmul_cipher", copy.deepcopy(TINY_CFG),
                  copy.deepcopy(TINY_WL), 1, per_layer, end_to_end)


def _run(cell, seed: int) -> dict:
    out = run.run_cell(cell, seed, 0.2, False, device="cpu",
                       t_start=time.perf_counter())
    return run.result_line(out, 1, "cpu-test")


def test_program_matches_the_reference():
    """A whole run: every kept packed output decrypts, under the
    reference, to x w mod t at troy's positions."""
    out = run.run_cell(tiny_cell(), 2**33 + 71, 0.2, False, device="cpu",
                       t_start=time.perf_counter())
    v = out["verdict"]
    assert v["outputs"] > 0 and v["wrong"] == 0 and out["failed"] == 0
    assert v["words"] == v["outputs"] * 256
    assert v["noise_budget_bits"] > 0
    assert run.result_line(out, 1, "cpu-test")["correct"] is True


def _fake_trace(h_, tr, cell, s, issue, reqs, inflight, kernels):
    """A sub-window's summary from synthetic device events."""
    device = [("inverse_pair_kernel<7>", 10.0 * i, 10.0 * i + 8.0)
              for i in range(len(reqs))]
    out = tr.summarize(device, len(reqs), 10.0 * len(reqs) / 1e3)
    out["idle_gaps"] = []
    return out


def test_traced_line_reads_every_metric_of_the_cell():
    """A traced run with the cell's per-layer metrics, its three stages'
    among them, reads each of them, and is correct."""
    per_layer = h.Cell.load(CELL, ROOT).per_layer
    assert {f"stage_ms.{x}" for x in kind.STAGES} <= {
        m["name"] for m in per_layer}
    out = run.run_cell(tiny_cell(per_layer), 2**34 + 3, 0.2, True,
                       device="cpu", t_start=time.perf_counter(),
                       trace_fn=_fake_trace)
    line = run.result_line(out, 1, "cpu-test")
    assert set(line["metrics"]) == {m["name"] for m in per_layer}
    for x in kind.STAGES:
        assert line["metrics"][f"stage_ms.{x}"]["value"] > 0
    assert line["metrics"]["launches_per_req"]["value"] == 1.0
    assert line["correct"] is True


def test_control_fails_and_reference_passes():
    r = control.readings(tiny_cell(), 2**31 + 99)
    assert r["exact"]["wrong_words"] == 0 and r["exact"]["words"] > 0
    assert r["control"]["wrong_words"] > r["control"]["words"] // 4


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_caught(monkeypatch, fault):
    """The pack returns its input; half of each packed output's
    coefficients zero; one answer moved by Delta at a compared
    position."""
    from troy_tpu_torch.app import linear
    cell = tiny_cell()
    if fault == "altered":
        cell.wl["sample"] = 1
        where = int(ref.packed_layout(cell.wl["dims"],
                                      cell.wl["blocks"])[0][0][0])
        make = faults._after(faults._altered(cell, where))
    else:
        make = {"unchanged": faults._unchanged,
                "half": faults._after(faults._half)}[fault]
    monkeypatch.setattr(linear.MatmulHelper, "pack_outputs",
                        make(linear.MatmulHelper.pack_outputs))
    line = _run(cell, 2**32 + 31)
    assert line["correct"] is False
    assert line["checked"]["wrong_words"]["value"] > 0
    if fault == "altered":
        assert line["checked"]["wrong_words"]["value"] == 1


def test_cell_blocks_and_layout_at_its_size():
    """At n = 16384 the helper picks blocks (64, 16, 16), as the workload
    states, and troy's layout fills the one packed output's 16384
    coefficients, each once; the tiny cell's likewise fills its 256."""
    from troy_tpu_torch.app import linear
    c = h.Cell.load(CELL, ROOT)
    helper = linear.MatmulHelper(64, 128, 256, 16384, objective=0,
                                 pack_lwe=True)
    assert [helper.batch_block, helper.input_block,
            helper.output_block] == c.wl["blocks"] == [64, 16, 16]
    assert c.wl["dims"] == [64, 128, 256] and c.wl["pack_lwe"] is True
    for wl, n in ((c.wl, 16384), (TINY_WL, 256)):
        layout = ref.packed_layout(wl["dims"], wl["blocks"])
        assert len(layout) == 1
        idx, (rows, cols) = layout[0]
        assert np.array_equal(np.sort(idx), np.arange(n))
        B, _, O = wl["dims"]
        assert np.array_equal(np.sort(rows * O + cols), np.arange(B * O))


def test_reference_layout_against_the_helpers_positions():
    """Each block (di, dj) of a 23 x 59 output in blocks (12, 4, 5): 2 x 12
    blocks, ragged in both directions, packed 4 to a ciphertext into 6,
    lies where the port's ``decrypt_outputs`` reads it."""
    from troy_tpu_torch.app import linear
    helper = linear.MatmulHelper(23, 8, 59, 256, objective=0,
                                 pack_lwe=True)
    blocks = [helper.batch_block, helper.input_block, helper.output_block]
    assert blocks == [12, 4, 5]
    layout = ref.packed_layout([23, 8, 59], blocks)
    assert len(layout) == helper._packed_count() == 6
    col_blocks = -(-59 // blocks[2])
    seen = 0
    for di, dj, li, ui, lj, uj in helper._blocks():
        pid, off = divmod(di * col_blocks + dj, blocks[1])
        want = helper._positions(ui - li, uj - lj, off)
        idx, (rows, cols) = layout[pid]
        mine = (rows >= li) & (rows < ui) & (cols >= lj) & (cols < uj)
        got = np.zeros((ui - li, uj - lj), np.int64)
        got[rows[mine] - li, cols[mine] - lj] = idx[mine]
        assert np.array_equal(got, want)
        seen += int(mine.sum())
    assert seen == 23 * 59 == sum(len(i) for i, _ in layout)


def test_expected_is_the_product_mod_t():
    cfg, wl = TINY_CFG, TINY_WL
    data = ref.inputs(cfg, wl, np.random.default_rng(5))
    assert data["inputs"].shape == (2, 8, 8)
    assert data["weights"].shape == (2, 8, 32)
    assert data["inputs"].max() < 256 and data["weights"].max() < 256
    reqs = ref.draw(wl, np.random.default_rng(6), 50)
    assert reqs.shape == (50, 2) and set(np.unique(reqs)) == {0, 1}
    (idx, want), = ref.expected(cfg, wl, data, reqs[0])
    x = data["inputs"][reqs[0][0]].astype(object)
    w = data["weights"][reqs[0][1]].astype(object)
    y = np.dot(x, w) % cfg["plain_modulus"]
    full = np.zeros(256, np.uint64)
    full[idx] = want
    # block (0, dj) of oB = 8 columns: packed offset dj, row i, column j
    for i in (0, 7):
        for j in (0, 13, 31):
            assert full[i * 32 + (j % 8) * 4 + j // 8] == y[i, j]


def test_work_counts_by_hand():
    """One request of the cell: 8 input and 128 weight ciphertexts of
    (2, 2, n), the relin key and 4 automorphism keys of (2, 2, 3, n), one
    packed output: 79.69 MB. BEHZ's lift of 272 polynomials, the tensor of
    128 pairs, the finish of 48, and 16 + 4 x 16 = 80 key switches: 492.6
    million modular products, 88.2 us at the assumed integer peak."""
    c = h.Cell.load(CELL, ROOT)
    n = 16384
    assert kind._counts(c.cfg, c.wl) == (8, 128, 128, 16, 1, 4)
    nbytes, mul64 = kind.work_counts(c.cfg, c.wl)
    assert nbytes == ((8 + 128 + 1) * 2 * 2 * n + 5 * 2 * 2 * 3 * n) * 8
    assert nbytes == 79_691_776
    mulmods = (work.behz_lift(c.cfg, 272) + work.tensor(c.cfg, 128)
               + work.behz_finish(c.cfg, 48) + 80 * work.key_switch(c.cfg))
    assert mul64 == 3 * mulmods
    assert 492e6 < mulmods < 493e6
    assert work.key_switch(c.cfg) * 80 / mulmods == pytest.approx(0.298,
                                                                  abs=1e-3)
    seconds, by = work.least_seconds(nbytes, mul64)
    assert by == "operations" and seconds == pytest.approx(88.2e-6, rel=1e-3)


def test_configuration_is_troys():
    """The cell's primes and t are the conv2d cell's, troy's
    ``CoeffModulus::Create(16384, {60, 60, 60})`` and 2^41, as the port
    makes them; nothing cut."""
    import troy_tpu_torch as P
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = [x for x in bench["configs"]
             if x["name"] == "troy_app_matmul_bfv_n16384"][0]
    mine = json.loads((ROOT / entry["file"]).read_text())
    conv = json.loads((ROOT / "hebench/configs/troy_app_bfv_n16384.json")
                      .read_text())
    for key in ("poly_modulus_degree", "coeff_modulus", "plain_modulus",
                "security", "scheme"):
        assert mine[key] == conv[key], key
    assert mine["coeff_modulus"] == [
        q.value for q in P.CoeffModulus.create(16384, [60, 60, 60])]
    assert mine["reduced"] == entry["reduced"] == []
    cell = [w for w in bench["workloads"] if w["name"] == CELL][0]
    assert cell["chips"] == 1 and cell["traffic"] == "matmul_cipher_closed2"
