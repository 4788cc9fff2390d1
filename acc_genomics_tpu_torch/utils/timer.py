"""Lightweight profiling: named spans with global accumulation plus a
throughput scoreboard.

The counterpart of the reference's acc_lib/Timer.h PLACE_TIMER macros
and the per-invocation GCUPS accounting done from OpenCL events
(pairhmm/host/PairHMMFpga.cpp:90-96, smem/host/ocl.cpp:339-344).

``Timer(key)`` is the program's one span type.  It adds its host-clock
duration to the registry that ``timers()`` reads, from any thread, and
keeps it in ``elapsed``.  While a ``torch.profiler`` records the calling
thread, the span is also a ``record_function`` range of the same name,
so it lands in the trace on the profiler's clock beside the card's
kernels and copies; otherwise it opens no range.  A profiler records the
thread that started it, so spans on the engines' worker threads reach
the registry only.  Spans are host clocks: device time comes from CUDA
events or ``device_trace``.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from contextlib import ContextDecorator, contextmanager
from typing import Dict

import torch

_totals: Dict[str, float] = collections.defaultdict(float)
_counts: Dict[str, int] = collections.defaultdict(int)
_lock = threading.Lock()
# True on a thread that a torch profiler is recording
_profiling = torch._C._autograd._profiler_enabled


class Timer(ContextDecorator):
    def __init__(self, key: str):
        self.key = key
        self.elapsed = 0.0
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(self.key)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        with _lock:
            _totals[self.key] += self.elapsed
            _counts[self.key] += 1
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def timers() -> Dict[str, dict]:
    with _lock:
        return {
            k: {"total_s": _totals[k], "count": _counts[k]}
            for k in sorted(_totals)
        }


def reset_timers() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


class Scoreboard:
    """Tracks average/peak throughput, like the reference test programs'
    GCUPS/bandwidth scorecards (pairhmm/xlnx/pairhmm_test.cpp:440-463)."""

    def __init__(self):
        self.total_work = 0.0
        self.total_time = 0.0
        self.peak = 0.0

    def record(self, work: float, seconds: float) -> float:
        rate = work / seconds if seconds > 0 else 0.0
        self.total_work += work
        self.total_time += seconds
        self.peak = max(self.peak, rate)
        return rate

    @property
    def average(self) -> float:
        return self.total_work / self.total_time if self.total_time else 0.0


@contextmanager
def device_trace(logdir: str, device="cuda"):
    """torch.profiler trace of the block: CPU activity, plus the card's
    kernels and copies when ``device`` is a CUDA device; on exit the trace
    is written as a Chrome trace file (``trace-<pid>-<ns>.json``) under
    ``logdir``.  The counterpart of the reference's SDAccel timeline
    traces.  The program's spans (``Timer``) opened in the block are
    ranges of the trace.  Usage: ``with device_trace("traces",
    eng.device) as prof: eng.pairhmm_matrix(...)``; ``prof.key_averages()``
    sums the events."""
    from torch.profiler import ProfilerActivity, profile

    from acc_genomics_tpu_torch.device import resolve_device

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
