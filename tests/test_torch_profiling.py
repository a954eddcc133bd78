"""troy_tpu_torch/utils/profiling.py on the CPU: the Timer of troy's
benchmarks (test/timetest.cu:16-60) as troy_tpu's, and a torch.profiler
trace written as a Chrome trace."""

import json
import time

import pytest
import torch

from troy_tpu.utils import profiling as jprof

from troy_tpu_torch.utils.profiling import Timer, trace

torch.set_num_threads(1)


@pytest.mark.parametrize("cls", [Timer, jprof.Timer],
                         ids=["port", "troy_tpu"])
def test_timer_measure_tick_tock_and_report(cls):
    t = cls()
    for _ in range(3):
        with t.measure("op"):
            time.sleep(0.01)
    assert t.seconds("op") >= 0.03
    assert 5 < t.mean_ms("op") < 100
    t.tick("x")
    time.sleep(0.005)
    t.tock("x")
    assert t.seconds("x") >= 0.004
    lines = t.report().splitlines()
    assert [line.split()[0] for line in lines] == ["op", "x"]
    assert lines[0].endswith("x3") and lines[1].endswith("x1")
    t.tick("a")
    with pytest.raises(ValueError):
        t.tock("b")
    t.clear()
    assert t.report() == ""


def test_timer_tock_without_tick_raises():
    with pytest.raises(ValueError, match="without tick"):
        Timer().tock("never")


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as prof:
        (torch.arange(4096, dtype=torch.int64) * 3).sum()
    path = log_dir / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert prof.key_averages()


def test_trace_writes_nothing_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="inside"):
        with trace(str(tmp_path)):
            raise RuntimeError("inside")
    assert not (tmp_path / "trace.json").exists()
