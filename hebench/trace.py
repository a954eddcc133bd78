"""The traced sub-windows: short steady stretches of the cell's closed loop
under ``torch.profiler``, their device time, busy and idle share, and the
guard against lost events.

Two sub-windows over the same requests are traced. The first traces
device activity alone, with no stage events or ranges, so the host runs as
in an untraced run: every number of the run's line (``busy_s``,
``window_s``, the device time and operations per request, the top device
ops) is read from it. The second traces host ops too, which slows the
host; it only names the idle gaps of ``breakdown`` by what the host was
doing, and its gaps are as long as they were under that tracing.

The profiler has been seen to drop device events, mostly at the edges of
its window, so each edge gets idle host time and spin kernels, and a trace
is held to two checks before any number is read from it:

- counts: every device operation seen in the sub-window (the program's
  kernels, PyTorch's own copies and fills), name by name, equals the
  counts of one request of each class traced alone (the calibration)
  times the sub-window's requests of that class, and the kernel binding's
  launch counters (``_kernels.launch_counts``) over the sub-window equal
  the calibration's likewise;
- time: the device's busy time lies within the CUDA-event span of the
  same requests.

A trace that fails either is taken again (with longer edges), up to
``ATTEMPTS`` times; then the run fails: no time is read off a trace that
lost events.
"""

from __future__ import annotations

import collections
import re
import time

import torch

ATTEMPTS = 4
EDGE_PAD_S = 0.02
EDGE_GROWTH = 4
EDGE_SPINS = 4
SPIN = "spin_kernel"
# the device's busy time may exceed the events' span by this much (event
# resolution and the profiler's clock alignment)
SPAN_SLACK = 1.01
SPAN_SLACK_US = 20.0
TOP = 10


class LostEvents(RuntimeError):
    pass


def _edge(pad_s: float) -> None:
    time.sleep(pad_s)
    for _ in range(EDGE_SPINS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(pad_s)


def _events(prof) -> tuple:
    """(device events [(name, start_us, end_us)], host ranges [(name,
    start_us, end_us)]) of a finished profile. The profiler also puts the
    step and every ``record_function`` range on the device's timeline (as
    user annotations spanning their kernels): those are no device work."""
    device, host = [], []
    for e in prof.events():
        kind = str(getattr(e, "device_type", ""))
        rng = e.time_range
        if getattr(e, "is_user_annotation", False) or e.name.startswith(
                ("ProfilerStep", "hebench.")):
            if "CUDA" not in kind:
                host.append((e.name, float(rng.start), float(rng.end)))
            continue
        if "CUDA" in kind:
            device.append((e.name, float(rng.start), float(rng.end)))
        else:
            host.append((e.name, float(rng.start), float(rng.end)))
    return device, host


def profile(run, pad_s: float, host: bool = False) -> tuple:
    """Trace ``run()`` between two padded edges, device activity alone or
    with the host's ops (``host``); the profiler's first step traces one
    more call of ``run`` and drops it (a cold trace loses its first
    events). Returns ``run()``'s value and the events."""
    from torch.profiler import ProfilerActivity, profile as prof_, schedule
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host else [])
    with prof_(activities=activities,
               schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as p:
        run()
        torch.cuda.synchronize()
        p.step()
        _edge(pad_s)
        value = run()
        _edge(pad_s)
        p.step()
    return value, _events(p)


def counts(device: list) -> collections.Counter:
    """Device operations by name, spin kernels left out."""
    return collections.Counter(n for n, _, _ in device if SPIN not in n)


def union_us(intervals: list) -> tuple:
    """(busy microseconds of the union, the gaps [(start, end)] between
    its pieces), intervals sorted by start."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _work(device: list, span_ms: float) -> list:
    """The device events but spin kernels, checked against the CUDA-event
    span of their requests."""
    work = [(n, s, e) for n, s, e in device if SPIN not in n]
    if not work:
        raise LostEvents("no device event in the traced sub-window")
    busy, _ = union_us([(s, e) for _, s, e in work])
    if busy > span_ms * 1e3 * SPAN_SLACK + SPAN_SLACK_US:
        raise LostEvents(f"device busy {busy:.1f} us over the events' span "
                         f"of {span_ms * 1e3:.1f} us")
    return work


def summarize(device: list, requests: int, span_ms: float) -> dict:
    """The sub-window's numbers from its device events (spin kernels left
    out): window_s from the first device event's start to the last one's
    end, busy_s the union of device activity, device_ms_per_req the sum of
    device durations per request, ops_per_req the device operations per
    request, the top device ops."""
    work = _work(device, span_ms)
    start = min(s for _, s, _ in work)
    end = max(e for _, _, e in work)
    busy, _ = union_us([(s, e) for _, s, e in work])
    ops = collections.Counter()
    for n, s, e in work:
        ops[short(n)] += (e - s) * 1e-6
    return {"window_s": (end - start) * 1e-6, "busy_s": busy * 1e-6,
            "device_ms_per_req": sum(e - s for _, s, e in work) * 1e-3
            / requests,
            "ops_per_req": len(work) / requests,
            "device_ops": [[n, v] for n, v in ops.most_common(TOP)]}


def idle_gaps(device: list, host: list, span_ms: float) -> list:
    """The longest idle gaps of a sub-window traced with the host's ops,
    each named by the innermost host ranges that cover its start."""
    _, gaps = union_us([(s, e) for _, s, e in _work(device, span_ms)])
    idle = collections.Counter()
    for s, e in gaps:
        idle[_host_at(host, s)] += (e - s) * 1e-6
    return [[n, v] for n, v in idle.most_common(TOP)]


def short(name: str) -> str:
    """A device op's name without its return type, namespace and argument
    list (its template arguments kept: they tell passes apart)."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = re.sub(r"\((unsigned|long|int|float|double|at::|c10::|char|bool"
                  r"|std::|const|\)).*$", "", name)
    return name[:120]


def _host_at(host: list, t: float) -> str:
    """The harness's stage and the innermost other host range that cover
    time t, or "host idle"."""
    cover = [(s, e, n) for n, s, e in host if s <= t < e]
    if not cover:
        return "host idle"
    stage = [n for s, e, n in cover if n.startswith("hebench.")]
    inner = min(cover, key=lambda c: c[1] - c[0])[2]
    parts = ([min(stage, key=len)] if stage else []) + (
        [inner] if not inner.startswith("hebench.") else [])
    return " / ".join(parts) or inner
