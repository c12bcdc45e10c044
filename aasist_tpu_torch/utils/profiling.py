"""Profiling and timing instrumentation (counterpart of
``aasist_tpu/utils/profiling.py``).

  * ``trace(log_dir)``: a ``torch.profiler`` window over the host and, where
    there is one, the card, written to ``log_dir`` as a Chrome trace (view
    it in Perfetto or ``chrome://tracing``);
  * ``annotate(name)``: a named span in that trace
    (``torch.profiler.record_function``);
  * ``Timer``: steady-state timing, warm-up then timed repetitions, each
    ended by a host read of the function's scalar result (and on a card a
    ``torch.cuda.synchronize()``), so the work is done inside the window.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile the body and write ``log_dir/trace.json``; yields the
    ``torch.profiler.profile`` object.  On a card the window ends after
    the card has finished the body's work."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def annotate(name: str):
    """A named span of the trace, as a context manager."""
    return torch.profiler.record_function(name)


def _barrier(value) -> None:
    float(value)
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Timer:
    """Steady-state timing of a function that returns a scalar (a 0-d
    tensor or a number)."""

    def __init__(self, fn: Callable[..., object], warmup: int = 2,
                 reps: int = 5):
        self.fn = fn
        self.warmup = warmup
        self.reps = reps

    def measure(self, *args) -> Dict[str, float]:
        for _ in range(self.warmup):
            _barrier(self.fn(*args))
        times: List[float] = []
        for _ in range(self.reps):
            t0 = time.perf_counter()
            _barrier(self.fn(*args))
            times.append(time.perf_counter() - t0)
        return {
            "mean_s": statistics.fmean(times),
            "min_s": min(times),
            "max_s": max(times),
            "median_s": statistics.median(times),
        }
