"""Profiling helpers: wall-clock accumulation, the program's own spans, and
device trace capture.

The port of troy_tpu/utils/profiling.py. The reference ships only benchmark
Timer classes (test/timetest.cu:16-60, test/app/linear.cu:8-49); ``Timer``
keeps their tic/toc shape, and ``trace`` records a ``torch.profiler``
trace of the CPU and, where there is one, the card, written as a Chrome
trace (chrome://tracing, Perfetto).

    from troy_tpu_torch.utils.profiling import Timer, trace

    t = Timer()
    with t.measure("multiply"):
        out = ev.multiply(a, b)
        torch.cuda.synchronize()
    print(t.report())

    with trace("traces"):
        run_pipeline()

The program's spans. The evaluator, the app layer, the kernel binding and
set-up (context, keys, encoding, encryption) mark their steps with
``span(name)`` or ``@spanned(name)``. Recording is off by default: a span
then checks ``active`` and does nothing else (no clock read, no profiler
range). Turned on, each span keeps its name, its host start and end
(``time.perf_counter_ns``), its parent span and the request id the caller
set; when a ``torch.profiler`` is running, it also opens the range
``troy.<name>``, on the profiler's clock beside the device's events. Spans
read the host clock only and launch nothing, so a recorded call launches
the device work an unrecorded one does. One thread records at a time.

    from troy_tpu_torch.utils import profiling

    profiling.enable()
    for i, (a, b) in enumerate(pairs):
        profiling.request(i)
        ev.relinearize(ev.multiply(a, b), rlk)
    profiling.disable()
    print(profiling.report())            # mean ms per span name
    for s in profiling.spans():          # name, start_ns, end_ns, parent,
        ...                              # request, self_ns

While recording, the kernel binding also adds the host time of each launch
to its entry point's total (``_kernels.launch_host_ns``), and the program
counts its steps by caller with ``count(group, key, items)``: read with
``counts(group)`` (the evaluator's ``keyswitch_counts()``), forgotten by
``clear()``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

# recording on; read by every span and by the kernel binding's launch
active = False
# each span as [name, start_ns, end_ns, parent record or None, request];
# end_ns 0 while it is open
_records: List[list] = []
_open: List[list] = []
_request: Optional[int] = None
# counters kept while recording: {group: {key: [calls, items]}}
_counts: Dict[str, Dict[str, List[int]]] = {}


class _Totals:
    """Seconds and counts by name, reported one line a name in Timer's
    format: the timing path of both ``Timer`` and the span report."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    def start(self, name: str) -> None:
        self.seconds.setdefault(name, 0.0)
        self.count.setdefault(name, 0)

    def add(self, name: str, ns: int) -> None:
        self.start(name)
        self.seconds[name] += ns * 1e-9
        self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        return 1e3 * self.seconds[name] / max(1, self.count[name])

    def report(self) -> str:
        return "\n".join(f"{name:28s} {self.mean_ms(name):10.3f} ms/op "
                         f"x{self.count[name]}" for name in self.seconds)

    def clear(self) -> None:
        self.seconds.clear()
        self.count.clear()


class Timer:
    """Accumulating wall-clock timer (timetest.cu Timer). Work on the card
    is asynchronous: synchronize inside the measured region to time it."""

    def __init__(self):
        self._totals = _Totals()
        self._tick_at = None

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self._totals.add(name, time.perf_counter_ns() - t0)

    def tick(self, name: str):
        """Start an interval (reference Timer::registerTimer + tick)."""
        self._totals.start(name)
        self._tick_at = (name, time.perf_counter_ns())

    def tock(self, name: str):
        if self._tick_at is None or self._tick_at[0] != name:
            raise ValueError(f"tock({name}) without tick({name})")
        t0 = self._tick_at[1]
        self._tick_at = None
        self._totals.add(name, time.perf_counter_ns() - t0)

    def seconds(self, name: str) -> float:
        return self._totals.seconds[name]

    def mean_ms(self, name: str) -> float:
        return self._totals.mean_ms(name)

    def report(self) -> str:
        return self._totals.report()

    def clear(self):
        self._totals.clear()


class Span(NamedTuple):
    """A finished span: host clock in ns, the index of its parent in
    ``spans()`` (-1 for none), the request id set when it opened, and its
    self time (its duration less the parts its child spans cover)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: Optional[int]
    self_ns: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class _Recorded:
    """An open span while recording is on."""
    __slots__ = ("rec", "range")

    def __init__(self, name: str):
        self.rec = [name]

    def __enter__(self):
        self.rec += [0, 0, _open[-1] if _open else None, _request]
        _records.append(self.rec)
        _open.append(self.rec)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(f"troy.{self.rec[0]}")
            self.range.__enter__()
        self.rec[1] = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        if _open and _open[-1] is self.rec:
            _open.pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one step of the program, named ``name``;
    does nothing unless recording is on."""
    return _Recorded(name) if active else _OFF


def spanned(name: str):
    """``span(name)`` around every call of the decorated function; whether
    recording is on is read at each call."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not active:
                return fn(*args, **kwargs)
            with _Recorded(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(group: str, key: str, items: int = 1) -> None:
    """One call of ``key`` in ``group``, over ``items`` items; counted only
    while recording is on."""
    if active:
        c = _counts.setdefault(group, {}).setdefault(key, [0, 0])
        c[0] += 1
        c[1] += items


def counts(group: str) -> Dict[str, Tuple[int, int]]:
    """(calls, items) of each key of ``group`` counted since the last
    ``clear()``."""
    return {k: (c[0], c[1]) for k, c in _counts.get(group, {}).items()}


def enable() -> None:
    """Turn recording on; the spans recorded so far are kept."""
    global active
    active = True


def disable() -> None:
    global active
    active = False


def request(i: Optional[int]) -> None:
    """The request id of the spans opened from now on (None: none)."""
    global _request
    _request = i


def clear() -> None:
    """Forget the recorded spans, the counts and the request id; spans open
    now finish unrecorded."""
    global _request
    _records.clear()
    _open.clear()
    _counts.clear()
    _request = None


def spans() -> List[Span]:
    """The finished spans in the order they opened, with self times; a
    span's parent is its nearest finished enclosing span."""
    done = [r for r in _records if r[2]]
    index = {id(r): i for i, r in enumerate(done)}
    parents, child_ns = [], [0] * len(done)
    for r in done:
        p = r[3]
        while p is not None and id(p) not in index:
            p = p[3]
        q = -1 if p is None else index[id(p)]
        parents.append(q)
        if q >= 0:
            child_ns[q] += r[2] - r[1]
    return [Span(r[0], r[1], r[2], q, r[4], r[2] - r[1] - c)
            for r, q, c in zip(done, parents, child_ns)]


def report() -> str:
    """The recorded spans in Timer's format: mean ms per span of each name
    and the count."""
    totals = _Totals()
    for s in spans():
        totals.add(s.name, s.ns)
    return totals.report()


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the block (CPU, and CUDA when a
    card is present) and write it to ``log_dir/trace.json`` as a Chrome
    trace; yields the profiler. Raises if the profiler cannot start: there
    is no silent fallback."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
