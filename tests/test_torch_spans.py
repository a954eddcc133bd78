"""The program's spans and the kernel binding's launch counter
(troy_tpu_torch/utils/profiling.py, _kernels.launch) on the CPU, and the
readers of tools/hebench_spans.py on synthetic event lists and on a run of
the benchmark's tiny cells."""

import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from troy_tpu_torch import _kernels
from troy_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
# tools/ holds the span readings' script, which runs on the card
sys.path.insert(0, str(ROOT / "tools"))
import hebench_spans as hs  # noqa: E402

from hebench import harness as h  # noqa: E402
from hebench import run, trace  # noqa: E402
from hebench.tests import tiny  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


def _busy(ns: int) -> None:
    end = time.perf_counter_ns() + ns
    while time.perf_counter_ns() < end:
        pass


def test_span_nesting_self_time_and_request_ids():
    profiling.enable()
    profiling.request(7)
    with profiling.span("outer"):
        _busy(200_000)
        with profiling.span("inner"):
            _busy(300_000)
            with profiling.span("leaf"):
                _busy(100_000)
        profiling.request(8)
        with profiling.span("inner"):
            _busy(100_000)
    profiling.request(None)
    with profiling.span("alone"):
        pass
    got = profiling.spans()
    assert [s.name for s in got] == ["outer", "inner", "leaf", "inner",
                                     "alone"]
    assert [s.parent for s in got] == [-1, 0, 1, 0, -1]
    assert [s.request for s in got] == [7, 7, 7, 8, None]
    outer, inner, leaf, inner2, _ = got
    assert outer.self_ns == outer.ns - inner.ns - inner2.ns
    assert inner.self_ns == inner.ns - leaf.ns
    assert leaf.self_ns == leaf.ns >= 100_000
    assert inner.ns >= 400_000 and outer.self_ns >= 200_000
    for s in got[1:4]:
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns


def test_outermost_seconds_count_nested_calls_of_a_name_once():
    profiling.enable()
    with profiling.span("encode"):
        with profiling.span("encode"):
            _busy(100_000)
        with profiling.span("keygen"):
            with profiling.span("encode"):
                _busy(100_000)
    with profiling.span("encode"):
        _busy(100_000)
    got = profiling.spans()
    out = hs.outermost_seconds(got)
    assert out["encode"] == pytest.approx((got[0].ns + got[4].ns) * 1e-9)
    assert out["keygen"] == pytest.approx(got[2].ns * 1e-9)


def test_off_records_nothing_and_opens_no_profiler_range():
    @profiling.spanned("decorated")
    def f(x):
        with profiling.span("inner"):
            return x + 1

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as p:
        assert f(torch.ones(4)).sum() == 8
    assert not any(e.name.startswith("troy.") for e in p.events())
    assert profiling.spans() == []
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        f(torch.ones(4))
    profiling.disable()
    names = [e.name for e in p.events()]
    assert "troy.decorated" in names and "troy.inner" in names
    assert [s.name for s in profiling.spans()] == ["decorated", "inner"]
    assert not profiling.active


def test_spanned_reads_the_flag_at_each_call():
    calls = []

    @profiling.spanned("op")
    def op(a, b=0):
        calls.append((a, b))
        return a + b

    assert op.__name__ == "op"
    assert op(1, b=2) == 3
    profiling.enable()
    assert op(2) == 2
    profiling.disable()
    op(3)
    assert calls == [(1, 2), (2, 0), (3, 0)]
    assert [s.name for s in profiling.spans()] == ["op"]


def test_a_span_closes_when_its_block_raises():
    profiling.enable()
    with pytest.raises(KeyError):
        with profiling.span("outer"):
            with profiling.span("fails"):
                raise KeyError("x")
    with profiling.span("after"):
        pass
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [("outer", -1),
                                                 ("fails", 0), ("after", -1)]


def test_clear_inside_an_open_span_forgets_it():
    profiling.enable()
    with profiling.span("open"):
        profiling.clear()
        with profiling.span("kept"):
            pass
    assert [(s.name, s.parent) for s in profiling.spans()] == [("kept", -1)]


def test_report_is_in_timers_format():
    profiling.enable()
    for _ in range(2):
        with profiling.span("op"):
            with profiling.span("child"):
                _busy(50_000)
    lines = profiling.report().splitlines()
    assert [line.split()[0] for line in lines] == ["op", "child"]
    assert all(line.endswith("x2") and "ms/op" in line for line in lines)
    got = profiling.spans()
    mean_ms = (got[0].ns + got[2].ns) / 2 * 1e-6
    assert lines[0] == f"{'op':28s} {mean_ms:10.3f} ms/op x2"


def test_timer_and_recorder_share_one_report():
    """Timer's measurements and the recorder's spans go through one
    accumulate-and-report path: the same durations read the same lines;
    a Timer records no span."""
    t = profiling.Timer()
    profiling.enable()
    for _ in range(3):
        with profiling.span("x"):
            _busy(10_000)
    with t.measure("y"):
        pass
    profiling.disable()
    got = profiling.spans()
    assert [s.name for s in got] == ["x"] * 3
    for s in got:
        t._totals.add("x", s.ns)
    assert t.report().splitlines()[1] == profiling.report()


@pytest.fixture
def fake_entry(monkeypatch):
    """The kernel binding with one fake entry point (``troy_ntt``) that
    takes about 1 ms and returns success, and no library."""
    seen = []

    def entry(*args):
        seen.append(args)
        _busy(1_000_000)
        return 0

    monkeypatch.setattr(_kernels, "_lib", object())
    monkeypatch.setattr(_kernels, "_raw_stream", lambda device: 1234)
    monkeypatch.setitem(_kernels._entries, "troy_ntt", entry)
    _kernels.reset_launch_counts()
    yield seen
    _kernels.reset_launch_counts()


def test_launch_host_ns_counts_only_while_recording(fake_entry):
    x = torch.zeros(4, dtype=torch.int64)
    _kernels.launch("troy_ntt", 0, x, None, 3)
    assert fake_entry[0] == (x.data_ptr(), None, 3, 1234)
    assert _kernels.entry_launch_counts()["troy_ntt"] == 1
    assert not any(_kernels.launch_host_ns().values())
    profiling.enable()
    _kernels.launch("troy_ntt", 0, x)
    _kernels.launch("troy_ntt", 0, x)
    profiling.disable()
    ns = _kernels.launch_host_ns()
    assert ns["troy_ntt"] >= 2_000_000
    assert sum(ns.values()) == ns["troy_ntt"]
    assert _kernels.launch_counts()["A_ntt"] == 3
    _kernels.reset_launch_counts()
    assert not any(_kernels.launch_host_ns().values())
    assert not any(_kernels.entry_launch_counts().values())


def test_launch_host_ns_keeps_the_launch_error(fake_entry, monkeypatch):
    monkeypatch.setitem(_kernels._entries, "troy_ntt", lambda *a: 2)
    profiling.enable()
    with pytest.raises(RuntimeError, match="error 2"):
        _kernels.launch("troy_ntt", 0)
    assert _kernels.launch_host_ns()["troy_ntt"] > 0
    assert _kernels.entry_launch_counts()["troy_ntt"] == 0


# ---- tools/hebench_spans.py on synthetic events ----

def _event(name, start, end, id_, cuda=False, annotation=False):
    return types.SimpleNamespace(
        name=name, id=id_, is_user_annotation=annotation,
        device_type="DeviceType.CUDA" if cuda else "DeviceType.CPU",
        time_range=types.SimpleNamespace(start=start, end=end))


def test_profile_events_never_count_a_program_range_as_device_work():
    events = [
        _event("troy.keyswitch", 0, 100, 1, annotation=True),
        _event("troy.keyswitch", 5, 95, 2, cuda=True, annotation=True),
        _event("troy.keyswitch_contract", 50, 90, 3, cuda=True),
        _event("hebench.relinearize", 0, 120, 4, cuda=True),
        _event("ProfilerStep#1", 0, 200, 5, cuda=True),
        _event("cudaLaunchKernel", 60, 62, 900),
        _event("aten::cat", 10, 20, 6),
        _event("dyadic_mac_kernel<2, 8>", 70, 80, 900, cuda=True),
        _event("Memcpy DtoD", 81, 82, 901, cuda=True),
        _event("cudaMemcpyAsync", 63, 64, 901),
    ]
    device, launches, host = hs.profile_events(
        types.SimpleNamespace(events=lambda: events))
    assert device == [("dyadic_mac_kernel<2, 8>", 70.0, 80.0, 900),
                      ("Memcpy DtoD", 81.0, 82.0, 901)]
    assert launches == {900: 60.0, 901: 63.0}
    assert [n for n, _, _ in host] == ["troy.keyswitch", "cudaLaunchKernel",
                                       "aten::cat", "cudaMemcpyAsync"]


def _synthetic(requests: int):
    """Per request of 100 us: keyswitch (decompose, contract) launching
    kernels a (under decompose) and b, c (under contract), and one copy
    outside any span."""
    device, launches, host = [], {}, []
    for r in range(requests):
        t = 100.0 * r
        host += [("hebench.relinearize", t, t + 90),
                 ("troy.relinearize", t + 1, t + 89),
                 ("troy.keyswitch", t + 2, t + 80),
                 ("troy.keyswitch_decompose", t + 3, t + 20),
                 ("troy.keyswitch_contract", t + 21, t + 70)]
        for k, (name, at, dur) in enumerate((("a_kernel", 10, 5.0),
                                             ("b_kernel", 30, 7.0),
                                             ("c_kernel", 50, 3.0),
                                             ("copy_kernel", 85, 1.0))):
            corr = 10 * r + k
            launches[corr] = t + at
            device.append((name, t + at + 2, t + at + 2 + dur, corr))
    return device, launches, host


def test_device_time_goes_to_every_span_that_holds_the_launch():
    device, launches, host = _synthetic(3)
    got = hs.by_span(device, launches, host)
    assert set(got) == {"relinearize", "keyswitch", "keyswitch_decompose",
                        "keyswitch_contract"}
    assert got["keyswitch"][0] == pytest.approx(3 * 15.0)
    assert got["relinearize"][0] == pytest.approx(3 * 16.0)
    assert got["keyswitch_decompose"] == (pytest.approx(15.0),
                                          {"a_kernel": 3})
    assert got["keyswitch_contract"][1] == {"b_kernel": 3, "c_kernel": 3}
    assert hs.unmatched(device, launches) == 0
    del launches[2]
    assert hs.unmatched(device, launches) == 1
    assert hs.by_span(device, launches, host)["keyswitch"][1][
        "c_kernel"] == 2


def test_span_guard_holds_each_span_to_its_calibration():
    one = hs.by_span(*_synthetic(1))
    device, launches, host = _synthetic(4)
    seen = hs.by_span(device, launches, host)
    assert hs.span_faults(seen, [(one, 4)]) == []
    faults = hs.span_faults(seen, [(one, 5)])
    assert len(faults) == 4 and faults[0].startswith("span keyswitch:")
    lost = hs.by_span(device[1:], launches, host)
    assert any("keyswitch_decompose" in f
               for f in hs.span_faults(lost, [(one, 4)]))


def test_idle_gaps_named_by_the_innermost_program_span():
    device, _, host = _synthetic(2)
    plain = [(n, s, e) for n, s, e, _ in device]
    gaps = dict(trace.idle_gaps(plain, host, span_ms=0.2))
    assert gaps == {
        "hebench.relinearize / troy.keyswitch_decompose":
            pytest.approx(2 * 15e-6),
        "hebench.relinearize / troy.keyswitch_contract":
            pytest.approx(2 * (13 + 32) * 1e-6),
        "hebench.relinearize / troy.relinearize": pytest.approx(24e-6)}


# ---- the program's spans in the benchmark's tiny cells ----

SPANS = {
    "mul_relin": {"multiply": None, "bfv_lift_ntt": "multiply",
                  "bfv_convolve": "multiply", "bfv_tail": "multiply",
                  "relinearize": None, "keyswitch": "relinearize",
                  "keyswitch_decompose": "keyswitch",
                  "keyswitch_contract": "keyswitch"},
    "conv2d": {"conv2d": None, "tiles_stack": "conv2d",
               "tiles_cipher_ntt": "conv2d", "tiles_plain_ntt": "conv2d",
               "tiles_contract": "conv2d", "tiles_inverse_ntt": "conv2d",
               "tiles_unpack": "conv2d"},
}


def _tiny_scheme(kind, seed):
    cell = tiny.cell(kind)
    seeds = h.Seeds(seed)
    from hebench.reference import bfv
    secret = bfv.ternary_secret(seeds.secret, cell.cfg["poly_modulus_degree"])
    data = cell.ref.inputs(cell.cfg, cell.wl, seeds.inputs)
    reqs = cell.ref.draw(cell.wl, seeds.draws, 8)
    s = h.Scheme(cell.cfg, cell.wl, seeds, secret, "cpu")
    return cell, s, cell.kind.setup(s, cell.wl, data), reqs


@pytest.mark.parametrize("kind", sorted(SPANS))
def test_request_spans_nest_and_change_no_word(kind):
    """Every span of a request, under its parent, with the request's id;
    the recorded requests' outputs are the unrecorded ones' words."""
    profiling.enable()
    cell, s, st, reqs = _tiny_scheme(kind, 2**40 + 3)
    setup = hs.setup_readings(profiling.spans(), 1e3)
    assert setup["spans_s"]["context"] > 0 and setup["spans_s"]["keygen"] > 0
    assert setup["spans_s"]["encode"] > 0 and setup["spans_s"]["encrypt"] > 0
    assert 0 < setup["uncovered_s"] < 1e3
    profiling.clear()
    recorded = []
    for i, req in enumerate(reqs[:2]):
        profiling.request(i)
        recorded.append(cell.kind.kept(cell.kind.issue(s, st, req,
                                                       h.Stages(False))))
    got = profiling.spans()
    profiling.disable()
    names = {x.name for x in got}
    assert names == set(SPANS[kind])
    for x in got:
        want = SPANS[kind][x.name]
        assert (got[x.parent].name if x.parent >= 0 else None) == want
    assert {x.request for x in got} == {0, 1}
    per = hs.host_per_request(got, 2)
    assert per[kind if kind == "conv2d" else "multiply"]["ms"] > 0
    for name, v in per.items():
        assert 0 <= v["self_ms"] <= v["ms"]
    for i, req in enumerate(reqs[:2]):
        plain = cell.kind.kept(cell.kind.issue(s, st, req, h.Stages(False)))
        for a, b in zip(plain, recorded[i]):
            assert torch.equal(a, b)


# the ct x ct matmul cell's request (tests/test_hebench_matmul_cipher.py's
# tiny cell: 4 product ciphertexts, 2 trace steps); a keyswitch span's
# parent is relinearize or galois_fold
MATMUL_SPANS = {"matmul_cipher": None, "tiles_stack": "matmul_cipher",
                "tiles_cipher_lift": "matmul_cipher",
                "tiles_pair_multiply": "matmul_cipher",
                "relinearize": None, "keyswitch_decompose": "keyswitch",
                "keyswitch_contract": "keyswitch", "pack_outputs": None,
                "pack_prepare": "pack_outputs", "field_trace": "pack_outputs",
                "galois_fold": "field_trace",
                "pack_group_fold": "pack_outputs"}


def _tiny_matmul(seed):
    from test_hebench_matmul_cipher import tiny_cell
    from hebench.reference import bfv
    cell = tiny_cell()
    seeds = h.Seeds(seed)
    secret = bfv.ternary_secret(seeds.secret, cell.cfg["poly_modulus_degree"])
    data = cell.ref.inputs(cell.cfg, cell.wl, seeds.inputs)
    reqs = cell.ref.draw(cell.wl, seeds.draws, 4)
    s = h.Scheme(cell.cfg, cell.wl, seeds, secret, "cpu")
    return cell, s, cell.kind.setup(s, cell.wl, data), reqs


def test_matmul_cipher_spans_and_keyswitch_counts():
    """A request of the ct x ct cell: the tile spans under matmul_cipher,
    the pack's under pack_outputs, each trace step one galois_fold under
    field_trace holding exactly one keyswitch, and no keyswitch inside
    another; ``keyswitch_counts()`` reads 4 relinearizations of one
    polynomial and 2 folds of 4. Recording changes no word; off, nothing
    is recorded or counted."""
    from troy_tpu_torch import evaluator
    cell, s, st, reqs = _tiny_matmul(2**42 + 7)
    plain = cell.kind.kept(cell.kind.issue(s, st, reqs[0], h.Stages(False)))
    assert profiling.spans() == [] and evaluator.keyswitch_counts() == {}
    profiling.enable()
    profiling.request(0)
    got_words = cell.kind.kept(cell.kind.issue(s, st, reqs[0],
                                               h.Stages(False)))
    profiling.disable()
    got = profiling.spans()
    names = [x.name for x in got]
    assert set(names) == set(MATMUL_SPANS) | {"keyswitch"}
    for x in got:
        parent = got[x.parent].name if x.parent >= 0 else None
        if x.name == "keyswitch":
            assert parent in ("relinearize", "galois_fold")
        else:
            assert parent == MATMUL_SPANS[x.name], x.name
    assert names.count("relinearize") == 4 and names.count("galois_fold") == 2
    assert names.count("field_trace") == 1
    for i, x in enumerate(got):
        if x.name == "galois_fold":
            kids = [y.name for y in got if y.parent == i]
            assert kids == ["keyswitch"]
        if x.name == "keyswitch":
            p = x.parent
            while p >= 0:
                assert got[p].name != "keyswitch"
                p = got[p].parent
    assert names.count("keyswitch") == 6
    assert evaluator.keyswitch_counts() == {
        "relinearize": {"calls": 4, "polys": 4},
        "galois_fold": {"calls": 2, "polys": 8}}
    for a, b in zip(plain, got_words):
        assert torch.equal(a, b)
    profiling.clear()
    assert evaluator.keyswitch_counts() == {}
    cell.kind.issue(s, st, reqs[1], h.Stages(False))
    assert profiling.spans() == [] and evaluator.keyswitch_counts() == {}


def test_keyswitch_counts_of_the_other_callers():
    """A multiply and relinearize counts one switch of one polynomial; a
    field trace of one ciphertext, one fold of one a step; a hoisted
    rotation of 2 elements one call of 2 polynomials; apply_galois and
    apply_keyswitching one each."""
    from troy_tpu_torch import evaluator
    cell, s, st, reqs = _tiny_matmul(2**43 + 1)
    ct = st["inputs"][0].data[0][0]
    profiling.enable()
    s.ev.relinearize(s.ev.multiply(ct, ct), st["rlk"])
    s.ev.field_trace(ct, st["gk"], 5)
    s.ev.apply_galois_many(ct, [3, 5], st["gk"])
    s.ev.apply_galois(ct, 3, st["gk"])
    s.ev.apply_keyswitching(ct, s.keygen.create_keyswitch_key(
        s.keygen.secret_key))
    profiling.disable()
    assert evaluator.keyswitch_counts() == {
        "relinearize": {"calls": 1, "polys": 1},
        "galois_fold": {"calls": 3, "polys": 3},
        "apply_galois_many": {"calls": 1, "polys": 2},
        "apply_galois": {"calls": 1, "polys": 1},
        "apply_keyswitching": {"calls": 1, "polys": 1}}
    assert [x.name for x in profiling.spans()].count("keyswitch") == 7


@pytest.mark.parametrize("kind", sorted(SPANS))
def test_prepared_grids_in_the_tiny_cells(kind):
    """conv2d's weights, encoded at set-up, build their prepared grid at
    the first request, the only one to open ``tiles_plain_ntt`` and a
    second ``tiles_stack``, and every later request hits; mul_relin
    contracts nothing, so its share reads None."""
    from troy_tpu_torch.app import linear
    cell, s, st, reqs = _tiny_scheme(kind, 2**41 + 5)
    linear.reset_prepared_counts()
    profiling.enable()
    for i, req in enumerate(reqs[:3]):
        profiling.request(i)
        cell.kind.issue(s, st, req, h.Stages(False))
    got = profiling.spans()
    profiling.disable()
    reading = hs.prepared_reading(linear.prepared_counts())
    if kind == "mul_relin":
        assert reading == {"builds": 0, "hits": 0, "hit_share": None}
        return
    assert reading == {"builds": 1, "hits": 2,
                       "hit_share": pytest.approx(2 / 3)}
    assert [x.request for x in got if x.name == "tiles_plain_ntt"] == [0]
    assert [x.request for x in got if x.name == "tiles_stack"] == [0, 0, 1,
                                                                   2]


def _fake_trace(h_, tr, cell, s, issue, reqs, inflight, kernels):
    device = [("ntt_pass_kernel<1>", 10.0 * i, 10.0 * i + 8.0)
              for i in range(len(reqs))]
    out = tr.summarize(device, len(reqs), 10.0 * len(reqs) / 1e3)
    out["idle_gaps"] = []
    return out


@pytest.mark.parametrize("kind", sorted(SPANS))
def test_benchmark_runs_record_nothing(kind):
    """A traced run of the harness, every reading of it, leaves the
    recorder empty and the binding's host time at zero: recording stays
    off in the benchmark's runs."""
    _kernels.reset_launch_counts()
    per_layer = h.Cell.load({"mul_relin": "bfv32k_mul_relin",
                             "conv2d": "app_conv2d"}[kind], ROOT).per_layer
    out = run.run_cell(tiny.cell(kind, per_layer), 2**35 + 9, 0.2, True,
                       device="cpu", t_start=time.perf_counter(),
                       trace_fn=_fake_trace)
    assert out["verdict"]["wrong"] == 0
    assert not profiling.active
    assert profiling.spans() == []
    assert not any(_kernels.launch_host_ns().values())


def test_host_per_request_sums_spans_by_name():
    mk = profiling.Span
    recorded = [mk("a", 0, 1_000_000, -1, 0, 400_000),
                mk("b", 0, 600_000, 0, 0, 600_000),
                mk("a", 0, 3_000_000, -1, 1, 3_000_000)]
    got = hs.host_per_request(recorded, 2)
    assert got["a"] == {"ms": pytest.approx(2.0),
                        "self_ms": pytest.approx(1.7)}
    assert got["b"] == {"ms": pytest.approx(0.3), "self_ms":
                        pytest.approx(0.3)}
    assert np.isclose(hs.setup_readings(recorded, 10.0)["uncovered_s"],
                      10.0 - 0.004)


def test_span_window_on_the_cpu():
    """The span sub-window of the tiny mul_relin cell, host events for
    CUDA's: every pass's enqueue, the spans per request, no launch on the
    CPU, and an empty span costing less off than on."""
    cell, s, st, reqs = _tiny_scheme("mul_relin", 2**36 + 1)

    def issue(req, stages):
        return cell.kind.issue(s, st, req, stages)

    out = hs.span_window(h, issue, reqs[:3], 2, 2, _kernels, h.HostEvent)
    assert len(out["enqueue_ms_off"]) == len(out["enqueue_ms_on"]) == 2
    assert out["spans_per_req"] == len(SPANS["mul_relin"])
    assert set(out["spans"]) == set(SPANS["mul_relin"])
    assert out["launches_per_req"] == 0
    assert out["binding_host_us_per_launch"] == 0
    assert out["keyswitch_per_req"] == {"relinearize": {"calls": 1.0,
                                                         "polys": 1.0}}
    assert 0 < out["span_cost_ns"]["off"] < out["span_cost_ns"]["on"]
    assert not profiling.active and profiling.spans() == []


def test_span_window_reads_the_matmul_cipher_cell():
    """The span sub-window of the tiny ct x ct cell: its new spans, and
    4 relinearizations and 2 trace folds of 4 polynomials a request."""
    cell, s, st, reqs = _tiny_matmul(2**36 + 5)

    def issue(req, stages):
        return cell.kind.issue(s, st, req, stages)

    out = hs.span_window(h, issue, reqs[:2], 2, 2, _kernels, h.HostEvent)
    assert set(out["spans"]) == set(MATMUL_SPANS) | {"keyswitch"}
    assert out["keyswitch_per_req"] == {
        "galois_fold": {"calls": 2.0, "polys": 8.0},
        "relinearize": {"calls": 4.0, "polys": 4.0}}
    assert not profiling.active and profiling.spans() == []
