"""Profiling and timing instrumentation (counterpart of
``aasist_tpu/utils/profiling.py``).

  * ``trace(log_dir)``: a ``torch.profiler`` window over the host and, where
    there is one, the card, written to ``log_dir`` as a Chrome trace (view
    it in Perfetto or ``chrome://tracing``), opened by a warm-up that
    takes the records the profiler loses at a window's start
    (``warm_up_s``); ``read_trace`` counts a kernel's events in it, over
    the body's part of the window (``body_window_us``);
  * ``annotate(name, args)``: a named span in that trace
    (``torch.profiler.record_function``) while a profiler records, and a
    shared no-op otherwise, cheap enough for the hot path.  The program's
    spans are named by their layer: ``serving.*`` (``serving.py``),
    ``model.*`` (``models/aasist.py``, ``models/layers.py:run_encoder``),
    ``train.*`` (``train/loop.py:make_train_step``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch
import torch.autograd.profiler

# The profiler loses the first kernel records of each window on a card, more
# the older the process: a window with no warm-up lost 0, 1, 5 and 9 of its
# first 40 launches, 100 us apart, at 61, 75, 125 and 175 s of the process
# on an H100 (some 5 us of the window a second of age), PyTorch's own
# kernels as much as the ctypes-launched ones
# (aasist_tpu_torch/tools/trace_launches.py).  A window therefore opens with
# tiny kernels on the body's devices, each waited for, for WARM_UP_S plus
# WARM_UP_PER_S a second of the process's age, at most WARM_UP_MAX_S (the
# rate read would reach that at some five hours of age; read on a card only
# to ~4.5 min); the records lost are theirs.  Their span is WARM_UP_SPAN:
# the body's part of the window starts where it ends (``body_window_us``).
WARM_UP_S = 1e-3
WARM_UP_PER_S = 1e-4
WARM_UP_MAX_S = 0.1
WARM_UP_SPAN = "profiling.trace warm-up"
_IMPORTED = time.monotonic()


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; elsewhere since this
    module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED


def warm_up_s(age_s: float) -> float:
    """How long a window's warm-up lasts in a process ``age_s`` seconds
    old."""
    return min(WARM_UP_MAX_S, WARM_UP_S + WARM_UP_PER_S * age_s)


def _cards(devices) -> List[torch.device]:
    """The CUDA devices among ``devices`` (default: the current one), each
    once."""
    if devices is None:
        return [torch.device("cuda", torch.cuda.current_device())]
    out: List[torch.device] = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            d = torch.device("cuda", torch.cuda.current_device()
                             if d.index is None else d.index)
            if d not in out:
                out.append(d)
    return out


def _synchronize(cards: Sequence[torch.device]) -> None:
    for d in cards:
        torch.cuda.synchronize(d)


def _warm_up(cards: Sequence[torch.device], seconds: float) -> None:
    """Tiny kernels on ``cards``, each round waited for, for ``seconds``:
    the window's first records, which the profiler may lose."""
    bufs = [torch.zeros(1, device=d) for d in cards]
    end = time.monotonic() + seconds
    with annotate(WARM_UP_SPAN):
        while time.monotonic() < end:
            for buf in bufs:
                buf.add_(1.0)
            _synchronize(cards)


@contextlib.contextmanager
def trace(log_dir, devices: Optional[Iterable] = None):
    """Profile the body and write ``log_dir/trace.json``; yields the
    ``torch.profiler.profile`` object.  ``devices`` are the cards the body
    runs on (default: the current one; a mesh's parts may run on several).
    On a card the window opens after they have finished the work queued
    before it, then runs ``warm_up_s`` of tiny kernels on them (the span
    WARM_UP_SPAN) so that the records the profiler loses at a window's
    start are not the body's, and closes after they have finished the
    body's work."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cards = _cards(devices) if torch.cuda.is_available() else []
    if cards:
        activities.append(ProfilerActivity.CUDA)
        _synchronize(cards)
        warm = warm_up_s(process_age_s())
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        if cards:
            _warm_up(cards, warm)
        yield prof
        _synchronize(cards)
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def body_window_us(events: Sequence[dict]) -> Tuple[float, float]:
    """The body's part of a ``trace`` window, (start, end) in the trace's
    us: from the end of the warm-up span (or the window's start, where
    there is none) to the window's end.  What an idle share of the body is
    read over."""
    window = [e for e in events
              if e.get("name", "").startswith("PyTorch Profiler")]
    start = float(window[0]["ts"]) if window else 0.0
    end = start + float(window[0].get("dur", 0)) if window else 0.0
    warm = [float(e["ts"]) + float(e.get("dur", 0)) for e in events
            if e.get("name") == WARM_UP_SPAN and e.get("ph") == "X"]
    return (max(warm) if warm else start), end


def read_trace(path, match: str, n: int) -> Dict[str, object]:
    """The kernel events of a written trace whose name holds ``match``,
    against the ``n`` launches made: ``found``, their starts in us from the
    body's start (``body_window_us``); the runtime's launch calls by name,
    the ones with no kernel event (``orphans``: in a ``trace`` window, the
    warm-up's), and the least and greatest of a kernel's start less its
    launch call's (``skew_us``)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    t0, t1 = body_window_us(events)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = [e for e in kernels if match in e.get("name", "")]
    by_corr = {e.get("args", {}).get("correlation"): e for e in kernels}
    calls, orphans, skew = {}, [], []
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "aunch" in e.get("name", ""):
            calls[e["name"]] = calls.get(e["name"], 0) + 1
            k = by_corr.get(e.get("args", {}).get("correlation"))
            if k is None:
                orphans.append(round(float(e["ts"]) - t0, 1))
            else:
                skew.append(float(k["ts"]) - float(e["ts"]))
    return {"launches": n, "found": len(found),
            "starts_us": sorted(round(float(e["ts"]) - t0, 1)
                                for e in found),
            "body_us": round(t1 - t0, 1), "kernel_events": len(kernels),
            "launch_calls": calls, "orphans_us": orphans[:20],
            "n_orphans": len(orphans),
            "skew_us": ([round(min(skew), 1), round(max(skew), 1)]
                        if skew else None)}


def launches_in_trace(launch: Callable[[], object], n: int, match: str,
                      log_dir, devices: Optional[Iterable] = None
                      ) -> Dict[str, object]:
    """Call ``launch()`` once, then ``n`` times inside a ``trace`` window in
    ``log_dir``; ``read_trace`` of the kernels named with ``match``."""
    launch()
    _synchronize(_cards(devices))
    with trace(log_dir, devices):
        for _ in range(n):
            launch()
    return read_trace(Path(log_dir) / "trace.json", match, n)


# ``annotate``'s span while no profiler records: ``record_function`` would
# call into ``torch.ops.profiler`` all the same, 9-11 us a span on one CPU
# core of an H100 host or of a CPU-only one, against 0.5-0.6 us for this
# check and the shared no-op
_NO_SPAN = contextlib.nullcontext()


def annotate(name: str, args: object = None):
    """A named span of the trace, as a context manager: while a profiler
    records, ``torch.profiler.record_function(name, str(args))`` (``args``,
    such as a batch's sequence number, travel with the span); otherwise one
    shared no-op that makes no call into the profiler."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(
        name, None if args is None else str(args))
