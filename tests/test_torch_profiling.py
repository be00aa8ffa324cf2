"""`npf_gwwaveform_tpu_torch.utils.profiling` against
`npf_gwwaveform_tpu.utils.profiling`: `StepTimer.summary` equal to JAX's on
the same `time.perf_counter` readings (both modules' clocks replaced by
one list of times), and `trace` writing a Chrome trace of a block on the
CPU that lists the block's operators."""

import json
import os

import pytest
import torch

from npf_gwwaveform_tpu.utils import profiling as jprof
from npf_gwwaveform_tpu_torch.utils import profiling

torch.set_num_threads(1)

# 0.0 at start(), then one reading a tick: step times 1, 3, 0.5, ...
READINGS = [0.0, 1.0, 4.0, 4.5, 7.5, 7.75, 9.0, 9.5, 19.5, 20.0, 20.125, 21.0]


def _summary(module, readings, items, monkeypatch):
    it = iter(readings)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))
    timer = module.StepTimer(items)
    timer.start()
    for _ in readings[1:]:
        timer.tick()
    monkeypatch.undo()
    return timer.summary(), timer.times


@pytest.mark.parametrize("n", [2, 5, len(READINGS)])
def test_step_timer_summary_equals_jax(n, monkeypatch):
    got, times = _summary(profiling, READINGS[:n], 32, monkeypatch)
    ref, ref_times = _summary(jprof, READINGS[:n], 32, monkeypatch)
    assert times == ref_times and got == ref
    assert list(got) == ["steps", "mean_s", "p50_s", "p90_s", "items_per_s"]
    assert got["steps"] == n - 1


def test_step_timer_before_any_tick():
    timer = profiling.StepTimer()
    assert timer.summary() == jprof.StepTimer().summary() == {}
    timer.tick()  # a tick before start() records nothing, as JAX's
    assert timer.times == []


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "tr")
    x = torch.randn(64, 64)
    with profiling.trace(logdir) as d:
        assert d == logdir
        (x @ x).relu().sum()
    path = os.path.join(logdir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu" in names
