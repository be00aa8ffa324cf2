"""Tracing and step timing, the counterpart of
`npf_gwwaveform_tpu/utils/profiling.py`.

`trace(logdir)` records a block with `torch.profiler` (CPU activity, and
CUDA activity where a card is present) and writes a Chrome trace into
`logdir` (`trace.json`), which Perfetto or `chrome://tracing` opens.
`StepTimer` collects per-step wall times by hand: `start()`, then `tick()`
after each step, then `summary()` (steps, mean, p50, p90, items a second).
A card runs its work asynchronously, so a tick measures the card only
after `torch.cuda.synchronize()`; without it a tick times the host's
launches. The JAX module's `compiled_stats` (an XLA cost probe) has no
counterpart.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "StepTimer", "TRACE_FILE"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Record the block with `torch.profiler` and write its Chrome trace to
    `logdir/trace.json`; yields `logdir`:

        with trace("tr"):
            trainer.train_step(x, y)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StepTimer:
    """Per-step wall times and throughput, collected by hand.

    Usage: timer = StepTimer(batch_size); timer.start(); ...; timer.tick()
    after each step (after `torch.cuda.synchronize()` to time the card);
    timer.summary().
    """

    def __init__(self, items_per_step: int = 1):
        self.items_per_step = items_per_step
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self._t0 is not None:
            self.times.append(now - self._t0)
        self._t0 = now

    def summary(self) -> dict:
        """{steps, mean_s, p50_s, p90_s, items_per_s}; {} before any tick.
        p50 and p90 are the sorted times at n // 2 and int(0.9 n)."""
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        mean = sum(ts) / n
        return {
            "steps": n,
            "mean_s": mean,
            "p50_s": ts[n // 2],
            "p90_s": ts[int(n * 0.9)],
            "items_per_s": self.items_per_step / mean,
        }
