"""The port's own spans and launch counters over one cell of the benchmark
(``hebench/``) on the card: what each step of a request costs the host and
the device, and what set-up spends its time on.

    python3 tools/hebench_spans.py --workload <cell> --seed <n> [--seconds 2]
        [--passes 8] [--out chiprun_out/spans.json]

from the root of a checkout; the cell is one of ``BENCHMARK.json``'s. The
run makes the cell's inputs, scheme and set-up as ``hebench/run.py`` does,
with recording on (``troy_tpu_torch.utils.profiling``) from before the
scheme until ``gc.freeze`` (CUDA is started just before the scheme, to
keep its start out of the context's span); then, recording off, a closed
loop of ``--seconds`` sizes the sub-window as ``run.py`` does (about 0.5 s
of its rate, at least 16 requests). Over that sub-window's requests:

- the span sub-window: the cell's closed loop over them once to warm,
  then with recording off, then on, ``--passes`` times, no profiler: each
  span's host time and self time per request and the kernel binding's
  host time per launch (``_kernels.launch_host_ns``) from the "on"
  passes, and the mean host enqueue of a request in each pass: the median
  of the pairs' differences is what recording costs, beside the host ns
  of an empty span off and on;
- the span trace: the closed loop under ``torch.profiler`` with the host's
  ops, the harness's stage ranges and recording on, held to the
  calibration of one request traced alone likewise (``hebench/trace.py``'s
  guard, span by span): each span's device time per request (a device op
  counts under every span whose ``troy.`` range holds its launch, the
  launch matched to the op by correlation id), and the longest idle gaps,
  each named by the innermost host range that covers it.

Beside them, the app layer's prepared plaintext grids
(``troy_tpu_torch.app.linear.prepared_counts``): builds, hits and the hit
share over set-up (warm-up included), over the closed loop's timed
requests, and over the whole run; and the evaluator's key switches
(``troy_tpu_torch.evaluator.keyswitch_counts``, counted while recording
is on): calls and polynomials switched by caller (``relinearize``,
``galois_fold``, ...) over set-up and per request of the span
sub-window's "on" passes.

It prints the readings as one JSON line and writes them to ``--out``.
Nothing of this runs in the benchmark's own runs, which keep recording off.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# set-up spans read whole, outermost of each name summed
SETUP_SPANS = ("context", "keygen", "encode", "encrypt", "kernels_load")
# the host's launch and copy calls, whose correlation id names a device op
LAUNCH_PREFIXES = ("cu",)
ANNOTATIONS = ("ProfilerStep", "hebench.", "troy.")


# ---- readings from recorded spans (no card needed) ----

def outermost_seconds(recorded) -> dict:
    """Seconds of each span name summed over its outermost spans (those
    with no enclosing span of the same name), so nested calls count
    once."""
    out = collections.Counter()
    for s in recorded:
        p = s.parent
        while p >= 0 and recorded[p].name != s.name:
            p = recorded[p].parent
        if p < 0:
            out[s.name] += s.ns * 1e-9
    return out


def setup_readings(recorded, setup_s: float) -> dict:
    """Seconds of each set-up span name (outermost spans of the name,
    summed) and of set-up that no top-level span covers."""
    out = outermost_seconds(recorded)
    covered = sum(s.ns for s in recorded if s.parent < 0) * 1e-9
    return {"spans_s": {k: out.get(k, 0.0) for k in
                        SETUP_SPANS + tuple(sorted(set(out) -
                                                   set(SETUP_SPANS)))},
            "uncovered_s": setup_s - covered}


def host_per_request(recorded, requests: int) -> dict:
    """Each span name's host ms and self ms per request."""
    total, own = collections.Counter(), collections.Counter()
    for s in recorded:
        total[s.name] += s.ns
        own[s.name] += s.self_ns
    return {k: {"ms": total[k] * 1e-6 / requests,
                "self_ms": own[k] * 1e-6 / requests} for k in total}


def keyswitch_per_request(passes: list, requests: int) -> dict:
    """Calls and polynomials of each caller's key switches per request,
    from one ``keyswitch_counts()`` reading a pass over ``requests``
    requests in all."""
    out = {}
    for counts in passes:
        for k, v in counts.items():
            o = out.setdefault(k, {"calls": 0, "polys": 0})
            o["calls"] += v["calls"]
            o["polys"] += v["polys"]
    return {k: {c: x / requests for c, x in v.items()}
            for k, v in sorted(out.items())}


def prepared_reading(counts: dict) -> dict:
    """Builds, hits and the hit share (None with no contraction) of
    prepared plaintext grids, from ``prepared_counts()``."""
    uses = counts["builds"] + counts["hits"]
    return dict(counts, hit_share=counts["hits"] / uses if uses else None)


# ---- readings from a profile (synthetic lists in the tests) ----

def profile_events(prof) -> tuple:
    """(device ops [(name, start_us, end_us, correlation)], launches
    {correlation: host start_us}, host ranges and ops [(name, start_us,
    end_us)]) of a finished ``torch.profiler`` profile. Ranges of the
    step, the harness's stages and the program's spans are never device
    work, wherever the profiler puts them."""
    device, launches, host = [], {}, []
    for e in prof.events():
        rng, cuda = e.time_range, "CUDA" in str(getattr(e, "device_type",
                                                        ""))
        item = (e.name, float(rng.start), float(rng.end))
        if getattr(e, "is_user_annotation", False) or e.name.startswith(
                ANNOTATIONS):
            if not cuda:
                host.append(item)
        elif cuda:
            device.append(item + (e.id,))
        else:
            host.append(item)
            if e.name.startswith(LAUNCH_PREFIXES):
                launches[e.id] = item[1]
    return device, launches, host


def by_span(device: list, launches: dict, host: list) -> dict:
    """Each ``troy.`` span name's device ops: {name: (device us summed,
    Counter of op names)}; an op counts under every span whose range holds
    its launch. Spin kernels are left out."""
    from hebench import trace as tr
    ranges = [(n[len("troy."):], s, e) for n, s, e in host
              if n.startswith("troy.")]
    us, ops = collections.Counter(), {}
    for name, s, e, corr in device:
        if tr.SPIN in name or corr not in launches:
            continue
        at = launches[corr]
        for span, rs, re_ in ranges:
            if rs <= at < re_:
                us[span] += e - s
                ops.setdefault(span, collections.Counter())[
                    tr.short(name)] += 1
    return {k: (us[k], ops[k]) for k in ops}


def unmatched(device: list, launches: dict) -> int:
    """Device ops (not spins) whose launch the trace lacks."""
    from hebench import trace as tr
    return sum(1 for n, _, _, c in device
               if tr.SPIN not in n and c not in launches)


def span_faults(seen: dict, calib: list) -> list:
    """Where a span's device ops differ from the calibration: ``calib``
    holds (one request's ``by_span``, the requests like it) for each
    class."""
    want = {}
    for one, requests in calib:
        for k, (_, ops) in one.items():
            w = want.setdefault(k, collections.Counter())
            for op, v in ops.items():
                w[op] += v * requests
    faults = []
    for k in sorted(set(seen) | set(want)):
        got = seen[k][1] if k in seen else collections.Counter()
        if got != want.get(k, collections.Counter()):
            faults.append(f"span {k}: ops {dict(got)}, calibrated "
                          f"{dict(want.get(k, {}))}")
    return faults


# ---- the card ----

def _profile(fn, pad_s: float) -> tuple:
    """``fn()`` under ``torch.profiler`` with the host's ops, between the
    harness's padded edges, after one traced call that is dropped."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from hebench import trace as tr
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as p:
        fn()
        torch.cuda.synchronize()
        p.step()
        tr._edge(pad_s)
        value = fn()
        tr._edge(pad_s)
        p.step()
    return value, profile_events(p)


def span_trace(h, cell, s, issue, reqs, inflight, kernels) -> dict:
    """The span trace of ``reqs`` with recording on (module docstring)."""
    from hebench import run as hrun, trace as tr
    from troy_tpu_torch.utils import profiling
    classify = getattr(cell.kind, "request_class", lambda s, r: "all")
    classes = {}
    for r in reqs:
        classes.setdefault(classify(s, r), []).append(r)
    pad, faults = tr.EDGE_PAD_S, []

    def traced(members):
        profiling.clear()
        profiling.enable()
        try:
            return _profile(lambda: hrun._fixed_loop(
                h, issue, members, inflight, h.Stages(True), kernels), pad)
        finally:
            profiling.disable()
            profiling.clear()

    for attempt in range(tr.ATTEMPTS):
        calib, ops = [], collections.Counter()
        for members in classes.values():
            _, (device, launches, host) = traced(members[:1])
            calib.append((by_span(device, launches, host), len(members)))
            for op, v in tr.counts([d[:3] for d in device]).items():
                ops[op] += v * len(members)
        (span_ms, _), (device, launches, host) = traced(reqs)
        seen = by_span(device, launches, host)
        plain = [(n, a, b) for n, a, b, _ in device]
        lost = unmatched(device, launches)
        faults = [f"{lost} device ops without a launch"] if lost else []
        if tr.counts(plain) != ops:
            faults.append(f"device ops seen {dict(tr.counts(plain))}, "
                          f"calibrated {dict(ops)}")
        faults += span_faults(seen, calib)
        try:
            work = tr._work(plain, span_ms)
        except tr.LostEvents as e:
            faults.append(str(e))
        if not faults:
            total_us = sum(b - a for _, a, b in work)
            return {"requests": len(reqs),
                    "device_ms_per_req": total_us * 1e-3 / len(reqs),
                    "span_device_ms": {k: v[0] * 1e-3 / len(reqs)
                                       for k, v in sorted(seen.items())},
                    "span_ops_per_req": {
                        k: sum(v[1].values()) / len(reqs)
                        for k, v in sorted(seen.items())},
                    "idle_gaps": tr.idle_gaps(plain, host, span_ms)}
        print(f"[spans] attempt {attempt + 1} of {tr.ATTEMPTS}: "
              + "; ".join(faults), file=sys.stderr)
        pad *= tr.EDGE_GROWTH
    raise tr.LostEvents("the span trace lost events in every attempt: "
                        + "; ".join(faults))


def span_window(h, issue, reqs, inflight, passes, kernels,
                event=None) -> dict:
    """The span sub-window of ``reqs`` (module docstring); ``event``: the
    CUDA event type by default."""
    from troy_tpu_torch import evaluator
    from troy_tpu_torch.utils import profiling
    event = event or h.event_type(True)
    ids = itertools.count()

    def issue_id(req, stages):
        profiling.request(next(ids))
        return issue(req, stages)

    def loop():
        return h.closed_loop(issue_id, reqs, inflight, math.inf,
                             h.Stages(False, event), stop=len(reqs))

    off_ms, on_ms, recorded, switched = [], [], [], []
    launches = launch_ns = 0
    loop()
    for _ in range(passes):
        off_ms.append(1e3 * statistics.fmean(loop()["enqueue_s"]))
        profiling.clear()
        kernels.reset_launch_counts()
        profiling.enable()
        on_ms.append(1e3 * statistics.fmean(loop()["enqueue_s"]))
        profiling.disable()
        recorded += profiling.spans()
        switched.append(evaluator.keyswitch_counts())
        launches += sum(kernels.entry_launch_counts().values())
        launch_ns += sum(kernels.launch_host_ns().values())
        profiling.clear()
    cost = [b - a for a, b in zip(off_ms, on_ms)]
    return {"enqueue_ms_off": off_ms, "enqueue_ms_on": on_ms,
            "recording_cost_ms": statistics.median(cost),
            "recording_cost_quartiles_ms": statistics.quantiles(cost, n=4),
            "spans_per_req": len(recorded) / (passes * len(reqs)),
            "span_cost_ns": span_cost_ns(),
            "binding_host_us_per_launch": launch_ns * 1e-3 / max(1,
                                                                 launches),
            "launches_per_req": launches / (passes * len(reqs)),
            "keyswitch_per_req": keyswitch_per_request(
                switched, passes * len(reqs)),
            "spans": host_per_request(recorded, passes * len(reqs))}


def span_cost_ns(calls: int = 100_000) -> dict:
    """Host ns of one empty span with recording off and on, less an empty
    loop's, on this host."""
    from troy_tpu_torch.utils import profiling

    def per_call(body) -> float:
        t0 = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t0) / calls

    def bare():
        for _ in range(calls):
            pass

    def spans():
        for _ in range(calls):
            with profiling.span("cost"):
                pass

    empty = per_call(bare)
    off = per_call(spans) - empty
    profiling.enable()
    on = per_call(spans) - empty
    profiling.disable()
    profiling.clear()
    return {"off": off, "on": on}


def run(workload: str, seed: int, seconds: float, passes: int) -> dict:
    import torch
    t_torch = time.perf_counter()
    from hebench import harness as h, run as hrun
    from hebench.reference import bfv
    from troy_tpu_torch import evaluator
    from troy_tpu_torch.app import linear
    from troy_tpu_torch.utils import profiling
    kernels = hrun._program(ROOT)
    cell = h.Cell.load(workload)
    cfg, wl = cell.cfg, cell.wl
    seeds = h.Seeds(seed)
    t_ref = time.perf_counter()
    secret = bfv.ternary_secret(seeds.secret, cfg["poly_modulus_degree"])
    data = cell.ref.inputs(cfg, wl, seeds.inputs)
    reqs = cell.ref.draw(wl, seeds.draws, h.DRAWN)
    t_cuda = time.perf_counter()
    # CUDA's start, which the scheme's first device tensor would make
    # inside the context's span
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_scheme = time.perf_counter()
    profiling.clear()
    profiling.enable()
    s = h.Scheme(cfg, wl, seeds, secret, "cuda")
    st = cell.kind.setup(s, wl, data)

    def issue(req, stages):
        return cell.kind.issue(s, st, req, stages)

    inflight = wl["inflight"]
    t_warm = time.perf_counter()
    warm = list(getattr(cell.kind, "warm", lambda s: [])(s))
    warm += list(reqs[:wl["warm"]])
    h.closed_loop(issue, warm, inflight, math.inf,
                  h.Stages(False, torch.cuda.Event), stop=len(warm))
    torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    t_end = time.perf_counter()
    profiling.disable()
    setup = setup_readings(profiling.spans(), t_end - T_START)
    setup["keyswitch"] = evaluator.keyswitch_counts()
    setup.update(setup_s=t_end - T_START,
                 phases_s={"import_torch": t_torch - T_START,
                           "import_harness_and_program": t_ref - t_torch,
                           "reference_inputs": t_cuda - t_ref,
                           "cuda_start": t_scheme - t_cuda,
                           "scheme_and_kind_setup": t_warm - t_scheme,
                           "warm_up": t_end - t_warm})
    profiling.clear()
    prepared = {"setup": linear.prepared_counts()}
    linear.reset_prepared_counts()

    win = h.closed_loop(issue, reqs, inflight, seconds,
                        h.Stages(False, torch.cuda.Event), first=wl["warm"])
    prepared["timed"] = linear.prepared_counts()
    rate = win["count"] / (win["end"] - win["start"])
    r = max(hrun.TRACE_MIN_REQUESTS, round(rate * hrun.TRACE_WINDOW_S))
    sub = reqs[win["next"]:win["next"] + r]
    out = {"workload": workload, "seed": seed, "setup": setup,
           "closed_req_per_s": rate,
           "host_enqueue_ms": 1e3 * statistics.fmean(win["enqueue_s"]),
           "window": span_window(h, issue, sub, inflight, passes, kernels),
           "trace": span_trace(h, cell, s, issue, sub, inflight, kernels)}
    prepared["run"] = {k: v + prepared["setup"][k]
                       for k, v in linear.prepared_counts().items()}
    out["prepared"] = {k: prepared_reading(v) for k, v in prepared.items()}
    out["card"] = torch.cuda.get_device_name(0)
    gc.unfreeze()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--passes", type=int, default=8)
    p.add_argument("--out")
    a = p.parse_args(argv)
    out = run(a.workload, a.seed, a.seconds, a.passes)
    line = json.dumps(out)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
