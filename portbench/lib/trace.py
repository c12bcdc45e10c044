"""The traced window and what is read from it.

``window(on)`` opens a ``torch.profiler`` window over the host and the
card.  Its warm-up is a copy of ``aasist_tpu_torch/utils/profiling.py:
trace``'s: the profiler loses the first kernel records of a window, more
the older the process, so the window opens with tiny kernels, each waited
for, for 1 ms plus 0.1 ms a second of the process's age (at most 0.1 s);
the records lost are theirs.  The body's part of the window starts where
the warm-up span ends and ends at a span the harness marks after its last
synchronise (the arithmetic of ``profiling.py:body_window_us``).

``read(prof)`` returns a ``Trace``: the device's operations inside the
body, the host's spans, and the union of the device's busy intervals.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

WARM_UP_S = 1e-3
WARM_UP_PER_S = 1e-4
WARM_UP_MAX_S = 0.1
WARM_UP_SPAN = "portbench.trace warm-up"
END_SPAN = "portbench.window end"
ANNOTATIONS = ("portbench", "PyTorch Profiler", "ProfilerStep")
NAME_CHARS = 160
_IMPORTED = time.monotonic()


def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``; elsewhere
    since this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED


def span(name: str):
    """A named host span in the trace (a no-op outside a window)."""
    return torch.profiler.record_function(name)


def synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def window(on: bool) -> Iterator[Optional[object]]:
    """A profiler window around the body when ``on``; yields the profiler
    (None when off)."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if card else [])
    synchronize()
    warm = min(WARM_UP_MAX_S, WARM_UP_S + WARM_UP_PER_S * process_age_s())
    with profile(activities=activities) as prof:
        if card:
            buf = torch.zeros(1, device="cuda")
            end = time.monotonic() + warm
            with span(WARM_UP_SPAN):
                while time.monotonic() < end:
                    buf.add_(1.0)
                    torch.cuda.synchronize()
        yield prof
        synchronize()
        with span(END_SPAN):
            pass


@dataclasses.dataclass
class Trace:
    start_ns: int
    end_ns: int
    device_ops: List[Tuple[str, int, int]]   # (name, start, end) ns
    host_spans: List[Tuple[str, int, int]]

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def kernels(self) -> List[Tuple[str, int, int]]:
        """The device's kernels (no copies or memsets)."""
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self, ops: Optional[Sequence[Tuple[str, int, int]]] = None
               ) -> float:
        """Seconds of the body covered by the union of ``ops`` (default:
        every device operation)."""
        return sum(b - a for a, b in union(
            self.device_ops if ops is None else ops)) / 1e9

    def seconds(self, patterns: Sequence[str]) -> float:
        """Summed seconds of the kernels whose name holds one of
        ``patterns`` (case blind)."""
        pats = [p.lower() for p in patterns]
        return sum(b - a for name, a, b in self.kernels()
                   if any(p in name.lower() for p in pats)) / 1e9

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host span open where the gap
        began."""
        by_name: Dict[str, int] = {}
        for name, a, b in self.device_ops:
            by_name[name] = by_name.get(name, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps, at = [], self.start_ns
        for a, b in union(self.device_ops) + [(self.end_ns, self.end_ns)]:
            if a > at:
                gaps.append((a - at, at))
            at = max(at, b)
        gaps = sorted(gaps, reverse=True)[:n]
        return {
            "device_ops": [[name[:NAME_CHARS], ns / 1e9]
                           for name, ns in ops],
            "idle_gaps": [[self.host_at(t0), ns / 1e9] for ns, t0 in gaps]}

    def host_at(self, t: int) -> str:
        """The host spans open at ``t``, outermost first."""
        open_ = sorted((s for s in self.host_spans if s[1] <= t < s[2]),
                       key=lambda s: s[1])
        return " > ".join(s[0][:48] for s in open_[-3:]) or "(no span)"


def union(ops: Sequence[Tuple[str, int, int]]) -> List[Tuple[int, int]]:
    """Disjoint (start, end) intervals covering ``ops``."""
    out: List[Tuple[int, int]] = []
    for _, a, b in sorted(ops, key=lambda op: op[1]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read(prof) -> Trace:
    """The body of a profiler window: device operations clipped to it and
    the host's annotated spans and operators inside it."""
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    warm = [e.end_ns() for e in events if e.name() == WARM_UP_SPAN]
    ends = [e.start_ns() for e in events if e.name() == END_SPAN]
    starts = [e.start_ns() for e in events]
    t0 = max(warm) if warm else min(starts)
    t1 = max(ends) if ends else max(e.end_ns() for e in events)
    dev, host = [], []
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if b <= t0 or a >= t1:
            continue
        if e.device_type() == cpu:
            if e.is_user_annotation() or e.name().startswith("aten::"):
                host.append((e.name(), a, b))
        elif not (e.is_user_annotation()
                  or e.name().startswith(ANNOTATIONS)):
            # the device's own operations; a host span's image on the
            # device's timeline is no operation
            dev.append((e.name(), max(a, t0), min(b, t1)))
    return Trace(t0, t1, dev, host)
