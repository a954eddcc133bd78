"""Run one cell of the benchmark once and print its result line.

    python3 hebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic, request
kind, reference and per-layer readers are found by name (``harness.py``).
A run makes its secret key, inputs and request sequence from ``--seed``,
encrypts the request pool, warms up the cell's own requests (set-up ends
there), runs the closed loop for ``--seconds``, and checks a sample of the
window's outputs, drawn from the seed, against the plain reference.
Where the cell reports ``card_req_per_s``, a fixed number of requests
then runs with the card's queue filled ahead (``harness.fed_loop``). With
``--trace 1`` it reports the per-layer metrics instead of the end-to-end
ones, from CUDA events around each call and two profiled sub-windows.

It exits non-zero and prints no result without a CUDA card (or fewer cards
than the cell asks for), when a module of JAX or of the JAX package is
loaded, or when the program is not beside it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# profiled sub-windows: about this many seconds of the window's rate
TRACE_WINDOW_S = 0.5
TRACE_MIN_REQUESTS = 16


class RunFailed(RuntimeError):
    pass


def _program(root: Path):
    """The program under test, which must come from this checkout."""
    import troy_tpu_torch
    where = Path(troy_tpu_torch.__file__).resolve()
    if root not in where.parents:
        raise RunFailed(f"troy_tpu_torch was loaded from {where}, not from "
                        f"the checkout {root}")
    from troy_tpu_torch import _kernels
    return _kernels


def _fixed_loop(h, issue, reqs, inflight, stages, kernels):
    """Every request of reqs with ``inflight`` outstanding; (the CUDA-event
    span in ms, the launch counters' increase)."""
    import torch
    before = kernels.launch_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    h.closed_loop(issue, reqs, inflight, math.inf, stages, stop=len(reqs))
    b.record()
    b.synchronize()
    after = kernels.launch_counts()
    return a.elapsed_time(b), {k: after[k] - before[k] for k in after
                               if after[k] != before[k]}


def _guarded(h, tr, classes, calib, issue, reqs, inflight, kernels, pad,
             host):
    """One traced sub-window of ``reqs`` (with the stage ranges and the
    host's ops where ``host``): its events and CUDA-event span, or the
    faults that show it lost events."""
    (span_ms, launches), (device, host_ev) = tr.profile(
        lambda: _fixed_loop(h, issue, reqs, inflight, h.Stages(host),
                            kernels), pad, host)
    want_k, want_l = {}, {}
    for c, members in classes.items():
        for want, got in ((want_k, calib[c][0]), (want_l, calib[c][1])):
            for k, v in got.items():
                want[k] = want.get(k, 0) + v * len(members)
    faults = []
    seen = dict(tr.counts(device))
    if seen != want_k:
        faults.append(f"device ops seen {seen}, calibrated {want_k}")
    if launches != want_l:
        faults.append(f"launches {launches}, calibrated {want_l}")
    return device, host_ev, span_ms, faults


def traced_window(h, tr, cell, s, issue, reqs, inflight, kernels):
    """The traced sub-windows of ``reqs`` (``trace.py``), held to the
    calibration of one request of each class traced alone; raises
    ``tr.LostEvents`` after ``tr.ATTEMPTS`` traces that lost events."""
    classify = getattr(cell.kind, "request_class", lambda s, r: "all")
    classes = {}
    for r in reqs:
        classes.setdefault(classify(s, r), []).append(r)
    pad, faults = tr.EDGE_PAD_S, []
    for attempt in range(tr.ATTEMPTS):
        calib = {}
        for c, members in classes.items():
            one = members[:1]
            (_, launches), (device, _) = tr.profile(
                lambda: _fixed_loop(h, issue, one, 1, h.Stages(False),
                                    kernels), pad)
            calib[c] = (tr.counts(device), launches)
        try:
            device, _, span_ms, faults = _guarded(
                h, tr, classes, calib, issue, reqs, inflight, kernels, pad,
                False)
            if not faults:
                out = tr.summarize(device, len(reqs), span_ms)
                device, host, span_ms, faults = _guarded(
                    h, tr, classes, calib, issue, reqs, inflight, kernels,
                    pad, True)
                if not faults:
                    out["idle_gaps"] = tr.idle_gaps(device, host, span_ms)
                    return out
        except tr.LostEvents as e:
            faults.append(str(e))
        print(f"[trace] attempt {attempt + 1} of {tr.ATTEMPTS}: "
              + "; ".join(faults), file=sys.stderr)
        pad *= tr.EDGE_GROWTH
    raise tr.LostEvents("the profiler lost events in every attempt: "
                        + "; ".join(faults))


def card_fed(h, issue, reqs, first, wl, enqueue_s, keep_pos, keep):
    """The fed chunks on the card (``harness.fed_loop``)."""
    return h.fed_loop(issue, reqs, first, wl["fed_requests"],
                      wl["fed_chunk"], enqueue_s, h.Stages(False), keep_pos,
                      keep, h.spin_clock())


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START,
             trace_fn=None, fed_fn=None) -> dict:
    """One run of a cell (``harness.Cell``); returns the result line's
    fields. ``trace_fn`` takes the profiled sub-window: on the card
    ``traced_window``; ``fed_fn`` the fed chunks behind
    ``card_req_per_s``: on the card ``card_fed``. Where every op runs on
    the host, neither is taken unless a test hands one in."""
    import torch
    from hebench import harness as h
    from hebench.reference import bfv
    kernels = _program(ROOT)
    cfg, wl = cell.cfg, cell.wl
    on_card = torch.device(device).type == "cuda"
    seeds = h.Seeds(seed)
    secret = bfv.ternary_secret(seeds.secret, cfg["poly_modulus_degree"])
    data = cell.ref.inputs(cfg, wl, seeds.inputs)
    reqs = cell.ref.draw(wl, seeds.draws, h.DRAWN)
    s = h.Scheme(cfg, wl, seeds, secret, device)
    st = cell.kind.setup(s, wl, data)

    def issue(req, stages):
        return cell.kind.issue(s, st, req, stages)

    inflight = wl["inflight"]
    warm = list(getattr(cell.kind, "warm", lambda s: [])(s))
    warm += list(reqs[:wl["warm"]])
    event = h.event_type(on_card)
    h.closed_loop(issue, warm, inflight, math.inf, h.Stages(False, event),
                  stop=len(warm))
    h.synchronize(on_card)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    # set-up's objects (keys, pool, weights) leave the collector's scans:
    # a collection in the window walks the window's objects alone
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    stages = h.Stages(trace, event)
    res = h.Reservoir(wl["sample"], seeds.sample)
    win = h.closed_loop(issue, reqs, inflight, seconds, stages, res,
                        keep=cell.kind.kept, first=wl["warm"])
    span_s = win["end"] - win["start"]
    lat_ms = [x * 1e3 for x in win["latency_s"]]
    closed = {"req_per_s": win["count"] / span_s,
              "latency_ms_p50": h.quantile(lat_ms, 0.50),
              "latency_ms_p95": h.quantile(lat_ms, 0.95)}
    print("[closed] " + ", ".join(f"{k} {v!r}" for k, v in closed.items()),
          file=sys.stderr)
    wanted = [m["name"] for m in cell.end_to_end]
    fed_fn = fed_fn or (card_fed if on_card else None)
    fed = None
    if not trace and "card_req_per_s" in wanted and fed_fn is not None:
        keep_pos = int(seeds.fed.integers(0, wl["fed_requests"]))
        try:
            fed = fed_fn(h, issue, reqs, win["next"], wl,
                         statistics.fmean(win["enqueue_s"]), keep_pos,
                         cell.kind.kept)
        except h.FedLate as e:
            raise RunFailed(str(e)) from e
        res.kept[win["next"] + keep_pos] = fed["kept"]
        print(f"[fed] {fed['requests']} requests in {fed['device_s']:.6f} "
              f"device s, {fed['misses']} chunks queued late",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    out = {"requests": win["count"], "seconds": span_s,
           "memory_peak_bytes": peak}
    metrics = {}
    if not trace:
        values = dict(closed, setup_s=setup_s)
        if fed is not None:
            values["card_req_per_s"] = fed["requests"] / fed["device_s"]
        units = {"req_per_s": "req/s", "latency_ms_p50": "ms",
                 "latency_ms_p95": "ms", "setup_s": "s",
                 "card_req_per_s": "req/s"}
        metrics = {k: (values[k], units[k]) for k in wanted if k in values}
    else:
        from hebench import trace as tr
        readings = {
            "requests": win["count"], "stage_ms": stages.means_ms(),
            "host_enqueue_ms": 1e3 * sum(win["enqueue_s"]) / win["count"],
            "work": cell.kind.work_counts(cfg, wl), "closed": closed}
        rate = closed["req_per_s"]
        r = max(TRACE_MIN_REQUESTS, round(rate * TRACE_WINDOW_S))
        sub = reqs[win["next"]:win["next"] + r]
        trace_fn = trace_fn or (traced_window if on_card else None)
        readings["trace"] = trace_fn and trace_fn(
            h, tr, cell, s, issue, sub, inflight, kernels)
        for m in cell.per_layer:
            value = h.read_metric(m["name"], readings)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        if readings["trace"] is not None:
            out["busy_s"] = readings["trace"]["busy_s"]
            out["window_s"] = readings["trace"]["window_s"]
            out["breakdown"] = {k: readings["trace"][k]
                                for k in ("device_ops", "idle_gaps")}
    kept = {i: h.host_words(v) for i, v in res.kept.items()}
    del st, s, res, issue
    if on_card:
        torch.cuda.empty_cache()
    gc.unfreeze()
    verdict = h.judge(cell, data, secret, kept, reqs)
    out.update(metrics=metrics, verdict=verdict,
               failed=verdict["failed_requests"])
    return out


def result_line(out: dict, chips: int, kind: str) -> dict:
    """The contract's last line; ``kind``: the card's name."""
    v = out["verdict"]
    device = {"platform": "gpu", "kind": kind,
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    for k in ("busy_s", "window_s"):
        if k in out:
            device[k] = out[k]
    line = {"correct": v["wrong"] == 0 and v["outputs"] > 0,
            "attempted": out["requests"], "failed": out["failed"],
            "metrics": {k: {"value": val, "unit": unit}
                        for k, (val, unit) in out["metrics"].items()},
            "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["noise_budget_bits"] = v["noise_budget_bits"]
    line["checked"] = {"wrong_words": {"value": v["wrong"], "limit": 0},
                       "outputs_checked": {"value": v["outputs"],
                                           "limit": "> 0"}}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch
    from hebench import harness as h
    cell = h.Cell.load(a.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: {a.workload} needs {chips} CUDA card(s), "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    try:
        out = run_cell(cell, a.seed, a.seconds, bool(a.trace))
    except RunFailed as e:
        print(f"no result: {e}", file=sys.stderr)
        return 4
    bad = h.forbidden_modules()
    if bad:
        print(f"no result: modules of {bad} are loaded", file=sys.stderr)
        return 5
    line = result_line(out, chips, torch.cuda.get_device_name(0))
    v = out["verdict"]
    print(f"noise budget left (bits, least over the kept outputs): "
          f"{v['noise_budget_bits']}", file=sys.stderr)
    print(f"outputs_checked {v['outputs']} limit > 0", file=sys.stderr)
    print(f"wrong_words {v['wrong']} limit 0 (of {v['words']} compared)",
          file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
