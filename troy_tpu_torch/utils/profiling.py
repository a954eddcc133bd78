"""Profiling helpers: wall-clock accumulation and device trace capture.

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
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict


class Timer:
    """Accumulating wall-clock timer (timetest.cu Timer). Work on the card
    is asynchronous: synchronize inside the measured region to time it."""

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._tick_at = None

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] = self._acc.get(name, 0.0) + \
                time.perf_counter() - t0
            self._count[name] = self._count.get(name, 0) + 1

    def tick(self, name: str):
        """Start an interval (reference Timer::registerTimer + tick)."""
        self._acc.setdefault(name, 0.0)
        self._count.setdefault(name, 0)
        self._tick_at = (name, time.perf_counter())

    def tock(self, name: str):
        if self._tick_at is None or self._tick_at[0] != name:
            raise ValueError(f"tock({name}) without tick({name})")
        t0 = self._tick_at[1]
        self._tick_at = None
        self._acc[name] += time.perf_counter() - t0
        self._count[name] += 1

    def seconds(self, name: str) -> float:
        return self._acc[name]

    def mean_ms(self, name: str) -> float:
        return 1e3 * self._acc[name] / max(1, self._count[name])

    def report(self) -> str:
        return "\n".join(f"{name:28s} {self.mean_ms(name):10.3f} ms/op "
                         f"x{self._count[name]}" for name in self._acc)

    def clear(self):
        self._acc.clear()
        self._count.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the block (CPU, and CUDA when a
    card is present) and write it to ``log_dir/trace.json`` as a Chrome
    trace; yields the profiler. Raises if the profiler cannot start: there
    is no silent fallback."""
    import torch
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
