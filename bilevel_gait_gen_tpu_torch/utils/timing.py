"""Timers + profiling helpers (port of
``bilevel_gait_gen_tpu/utils/timing.py``).

Replaces utils::Timer (utils/include/timer.h:14-36) and the MPCVerbosityLevel
timing printouts (mpc/include/mpc.h:32-37).  The host timers bracket
launching and synchronizing regions the way the reference brackets solver
stages; for the device's side, :func:`device_trace` records a
``torch.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class Timer:
    """Named steady-clock timer (utils::Timer semantics)."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        self.elapsed_ms = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        return self.elapsed_ms

    def print_elapsed(self):
        print(f"[timer] {self.name}: {self.elapsed_ms:.3f} ms")


class StageTimers:
    """Accumulating per-stage timers with a summary table."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += (time.perf_counter() - t0) * 1e3
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'stage':<28s} {'total ms':>10s} {'calls':>7s} {'avg ms':>9s}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<28s} {t:>10.2f} {c:>7d} {t / c:>9.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the block, with CPU and (where there is a
    card) CUDA activities; the Chrome trace is written into ``logdir``
    (``trace_<ns>.json``) when the block ends, as it raises too."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{time.time_ns()}.json"))
