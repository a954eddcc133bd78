"""CPU tests of the benchmark's harness: its files, names and imports, the
work counts behind ``roofline_share``, and whole runs of each request kind
at a tiny ring through the program's plain versions, held to the
reference.

    python -m pytest hebench/tests -q -p no:cacheprovider
"""

import ast
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest

from hebench import harness as h
from hebench import run, trace, work
from hebench.reference import bfv
from hebench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
HEBENCH = ROOT / "hebench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]
KINDS = sorted(tiny.WORKLOADS)
WORKLOAD_FILES = sorted(p.stem for p in (HEBENCH / "workloads").glob("*.json"))
CELL_OF_KIND = {h.Cell.load(c, ROOT).wl["kind"]: c for c in CELLS}


def from_files(name: str) -> h.Cell:
    """A cell from its workload and configuration files alone."""
    wl = json.loads((HEBENCH / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((HEBENCH / "configs" / f"{wl['config']}.json")
                     .read_text())
    return h.Cell(name, cfg, wl)


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hebench"]
    assert BENCH["command"] == ["python3", "hebench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", WORKLOAD_FILES)
def test_workload_files(cell):
    c = from_files(cell)
    assert c.wl["config"] == c.cfg["name"] and len(c.wl["why"]) <= 200
    assert hasattr(c.kind, "work_counts") and hasattr(c.ref, "expected")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = h.Cell.load(cell, ROOT)
    assert c.wl["config"] == c.cfg["name"]
    entry = [w for w in BENCH["workloads"] if w["name"] == cell][0]
    assert entry["chips"] == 1 and c.chips == 1
    assert entry["traffic"] == f"{c.wl['kind']}_closed{c.wl['inflight']}"
    assert c.wl["why"] == entry["why"] and len(entry["why"]) <= 200
    for key in ("inflight", "pool", "warm", "sample"):
        assert int(c.wl[key]) >= 1, key
    if "card_req_per_s" in [m["name"] for m in c.end_to_end]:
        assert 1 <= c.wl["fed_chunk"] <= c.wl["fed_requests"]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configs(config):
    entry = [c for c in BENCH["configs"] if c["name"] == config][0]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("hebench/configs/")
    assert cfg["name"] == config and cfg["reduced"] == entry["reduced"] == []
    n, q = cfg["poly_modulus_degree"], cfg["coeff_modulus"]
    assert all(bfv.is_prime(p) and p % (2 * n) == 1 for p in q)
    assert len(set(q)) == len(q)


def test_configs_are_their_sources():
    """The configurations' primes are SEAL's and troy's, as the port makes
    them too."""
    import troy_tpu_torch as P
    seal = json.loads((HEBENCH / "configs/seal_bfv_n32768.json").read_text())
    assert seal["coeff_modulus"] == [
        q.value for q in P.CoeffModulus.bfv_default(32768)]
    assert sum(q.bit_length() for q in seal["coeff_modulus"]) == 881
    assert seal["plain_modulus"] == P.PlainModulus.batching(32768, 20).value
    assert seal["plain_modulus"] == bfv.seal_primes(32768, [20])[0]
    app = json.loads((HEBENCH / "configs/troy_app_bfv_n16384.json")
                     .read_text())
    assert app["coeff_modulus"] == bfv.seal_primes(16384, [60, 60, 60]) == [
        q.value for q in P.CoeffModulus.create(16384, [60, 60, 60])]
    assert app["plain_modulus"] == 1 << 41


def test_names_and_units():
    names = ([m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + CELLS + [c["name"] for c in BENCH["configs"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [w["config"] for w in BENCH["workloads"]])
    for name in names:
        assert NAME.fullmatch(name), name
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got)), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for path in HEBENCH.rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_end_to_end_metrics():
    """The card's fed rate and set-up, in every cell; the closed loop's
    host-clock numbers are per-layer readings (``closed_loop.*``)."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"card_req_per_s", "setup_s"}
    assert e2e["card_req_per_s"]["source"] == "device_trace"
    assert e2e["setup_s"]["source"] == "host_clock"
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and "workloads" not in m
    assert e2e["setup_s"]["bound"] == 0.25
    closed = {m["name"] for m in BENCH["per_layer"]
              if m["name"].startswith("closed_loop.")}
    assert closed == {"closed_loop.req_per_s", "closed_loop.latency_ms_p50",
                      "closed_loop.latency_ms_p95"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric(metric):
    """Each metric moves an end-to-end metric its cells report, lists real
    cells, and has a reader; a stage's cells make that call."""
    m = [x for x in BENCH["per_layer"] if x["name"] == metric][0]
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        assert cell in e2e[m["moves"]].get("workloads", CELLS)
    base, _, part = metric.partition(".")
    assert (HEBENCH / "metrics" / f"{base}.py").exists()
    if base == "stage_ms":
        for cell in m["workloads"]:
            assert part.split(".")[0] in h.Cell.load(cell, ROOT).kind.STAGES
    layers = {x["layer"] for x in BENCH["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


def test_every_stage_has_a_metric():
    """Each call a cell's requests make has a stage metric listing the cell
    (``stage_ms.<stage>`` or ``stage_ms.<stage>.<anything>``)."""
    for cell in CELLS:
        for stage in h.Cell.load(cell, ROOT).kind.STAGES:
            assert any(cell in m.get("workloads", []) and (
                m["name"] + ".").startswith(f"stage_ms.{stage}.")
                for m in BENCH["per_layer"]), (cell, stage)


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(
    p.relative_to(HEBENCH).as_posix() for p in HEBENCH.rglob("*.py")))
def test_imports(path):
    """No module imports jax, jaxlib, flax or the JAX package (top-level
    names compared whole); the reference imports nothing of the program."""
    tops = _imports(HEBENCH / path)
    assert not tops & {"jax", "jaxlib", "flax", "troy_tpu"}, tops
    if path.startswith("reference/"):
        assert tops <= {"numpy", "__future__", "typing"}, tops


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "troy_tpu_torch_fake",
                        types.ModuleType("troy_tpu_torch_fake"))
    assert "troy_tpu" not in h.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert h.forbidden_modules() == ["jax"]


def test_work_counts_by_hand():
    """Against the figures reckoned by hand in PERF.md: an n = 32768 mult +
    relin moves 149.4 MB (two ciphertexts in, 15 key rows of (2, 16, n),
    one out), 44.6 us at 3.35 TB/s, and takes 763 million 64-bit
    products, 45.6 us at the assumed integer peak; the conv2d moves 497.0
    MB."""
    seal = h.Cell.load("bfv32k_mul_relin", ROOT)
    nbytes, mul64 = seal.kind.work_counts(seal.cfg, seal.wl)
    n = 32768
    assert nbytes == (3 * 2 * 15 * n + 15 * 2 * 16 * n) * 8 == 149_422_080
    assert abs(work.least_seconds(nbytes, 0)[0] - 44.60e-6) < 0.01e-6
    assert 740e6 < mul64 < 770e6
    assert work.least_seconds(nbytes, mul64)[0] == pytest.approx(
        mul64 * 4 / 67e12)
    conv = from_files("app_conv2d")
    nb, mul = conv.kind.work_counts(conv.cfg, conv.wl)
    m = 16384
    # 64 input and 52 output ciphertexts of (2, 2, n); 52 x 64 weights
    assert nb == ((64 + 52) * 2 * 2 * m + 52 * 64 * m) * 8 == 497_025_024
    assert work.least_seconds(nb, mul) == (mul * 4 / 67e12, "operations")


def _host_fed(h_, issue, reqs, first, wl, enqueue_s, keep_pos, keep):
    """The fed chunks with host events and no spin (every op on the CPU)."""
    return h_.fed_loop(issue, reqs, first, wl["fed_requests"],
                       wl["fed_chunk"], enqueue_s, h_.Stages(False, h.HostEvent),
                       keep_pos, keep, 1e9, h.HostEvent, lambda cycles: None)


@pytest.mark.parametrize("kind", KINDS)
def test_kind_at_a_tiny_ring(kind):
    """A whole untraced run on the CPU with the end-to-end metrics of the
    kind's cell: every kept output, the fed chunks' one among them,
    decrypts, under the reference, to the reference's answer."""
    e2e = h.Cell.load(CELL_OF_KIND[kind], ROOT).end_to_end
    cell = tiny.cell(kind, end_to_end=e2e)
    out = run.run_cell(cell, 2**31 + 77, 0.3, False, device="cpu",
                       t_start=time.perf_counter(), fed_fn=_host_fed)
    v = out["verdict"]
    assert v["outputs"] > 0 and v["words"] > 0
    assert v["wrong"] == 0 and out["failed"] == 0
    line = run.result_line(out, 1, "cpu-test")
    assert line["correct"] is True
    assert list(line)[-1] == "checked"
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert line["metrics"]["card_req_per_s"]["value"] > 0
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    json.dumps(line)


def _fake_trace(h_, tr, cell, s, issue, reqs, inflight, kernels):
    """A sub-window's summary from synthetic device events."""
    device = [("ntt_pass_kernel<1>", 10.0 * i, 10.0 * i + 8.0)
              for i in range(len(reqs))]
    span_ms = 10.0 * len(reqs) / 1e3
    out = trace.summarize(device, len(reqs), span_ms)
    out["idle_gaps"] = trace.idle_gaps(device, [("hebench.x", 0.0, 1e9)],
                                       span_ms)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_traced_line_keys(kind):
    """A traced run's line: every per-layer metric of the kind's cell, and
    one more per stage, device busy and window seconds, the breakdown."""
    stages = h.module("requests", kind).STAGES
    per_layer = h.Cell.load(CELL_OF_KIND[kind], ROOT).per_layer + [
        {"name": f"stage_ms.{s}.tiny", "unit": "ms"} for s in stages]
    out = run.run_cell(tiny.cell(kind, per_layer), 2**33 + 5, 0.3, True,
                       device="cpu", t_start=time.perf_counter(),
                       trace_fn=_fake_trace)
    line = run.result_line(out, 1, "cpu-test")
    assert set(line["metrics"]) == {m["name"] for m in per_layer}
    for m in per_layer:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["device_ops"]) <= 10
    assert 18 < line["metrics"]["device_idle_share"]["value"] < 20
    assert line["metrics"]["launches_per_req"]["value"] == 1.0
    assert line["metrics"]["closed_loop.req_per_s"]["value"] > 0
    assert line["breakdown"]["idle_gaps"][0][0] == "hebench.x"
    assert line["correct"] is True


def test_summarize_and_lost_events():
    dev = [("a_kernel", 0.0, 500.0), ("b_kernel", 500.0, 600.0),
           ("a_kernel", 1000.0, 1500.0), ("at::cuda::spin_kernel", 5e3, 6e3)]
    out = trace.summarize(dev, 2, span_ms=1.6)
    assert out["busy_s"] == pytest.approx(1.1e-3)
    assert out["window_s"] == pytest.approx(1.5e-3)
    assert out["device_ms_per_req"] == pytest.approx(0.55)
    assert out["ops_per_req"] == 1.5
    assert trace.idle_gaps(dev, [], 1.6) == [["host idle",
                                              pytest.approx(0.4e-3)]]
    assert trace.idle_gaps(dev, [("hebench.multiply", 550.0, 700.0),
                                 ("aten::cat", 580.0, 650.0)], 1.6) == [
        ["hebench.multiply / aten::cat", pytest.approx(0.4e-3)]]
    assert trace.counts(dev) == {"a_kernel": 2, "b_kernel": 1}
    with pytest.raises(trace.LostEvents):
        trace.summarize(dev, 2, span_ms=1.0)
    with pytest.raises(trace.LostEvents):
        trace.idle_gaps(dev, [], 1.0)
    with pytest.raises(trace.LostEvents):
        trace.summarize([("at::cuda::spin_kernel", 0, 1)], 1, 1.0)


def test_reservoir_is_seeded_and_uniform():
    def sample(seed):
        r = h.Reservoir(4, np.random.default_rng(seed))
        for i in range(100):
            r.offer(i + 3, lambda: i)
        return sorted(r.kept)
    assert sample(1) == sample(1) != sample(2)
    assert len(sample(3)) == 4


class _Event(h.HostEvent):
    """A CUDA event's stand-in whose start the card has passed (the chunk
    was queued late) in the first ``late`` chunks."""
    late = 0
    made = 0

    def record(self) -> None:
        super().record()
        _Event.made += 1

    def query(self) -> bool:
        return (_Event.made + 1) // 2 <= _Event.late


@pytest.mark.parametrize("late", [0, 3, h.FED_MISSES + 1])
def test_fed_loop_counts_chunks_queued_in_time(late):
    """Chunks whose start the card reached before the host queued them are
    issued again behind a spin twice as long and not counted; the run
    fails after ``FED_MISSES`` of them. The request at ``keep_pos`` is
    kept once, whatever the retries."""
    _Event.late, _Event.made = late, 0
    issued, spins = [], []

    def issue(req, stages):
        issued.append(int(req))
        return int(req)

    kwargs = dict(issue=issue, reqs=np.arange(100), first=10, requests=7,
                  chunk=3, enqueue_s=0.01, stages=h.Stages(False, _Event),
                  keep_pos=4, keep=lambda out: [out], clock=1e3,
                  event=_Event, sleep=spins.append)
    if late > h.FED_MISSES:
        with pytest.raises(h.FedLate):
            h.fed_loop(**kwargs)
        return
    out = h.fed_loop(**kwargs)
    assert out["requests"] == 7 and out["misses"] == late
    assert out["kept"] == [14] and out["next"] == 17 and out["device_s"] >= 0
    assert issued == [10, 11, 12] * (late + 1) + list(range(13, 17))
    first = int(h.FED_SPIN_FACTOR * 3 * 0.01 * 1e3)
    assert spins[:late + 1] == [first * 2 ** i for i in range(late + 1)]
