"""The program's own spans in a ``trace.Trace``: those that
``aasist_tpu_torch/utils/profiling.py:annotate`` records on the host
(``serving.*``, ``model.*``, ``train.*``), and the device's idle time
under them.  What the readers of program spans share
(``metrics/dispatch_ms.score.py``, ``dispatch_stall_ms.verify.py``,
``step_stall_ms.train.py``).  A trace of a program that records no such
span yields none, and its readers return None.

Intervals are (start, end) in the trace's ns; lists of them are sorted and
disjoint where a function says so.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from portbench.lib.trace import Trace, union

Interval = Tuple[int, int]


def named(trace: Trace, *names: str) -> List[Interval]:
    """The host spans called one of ``names``, sorted and made
    disjoint."""
    return union([s for s in trace.host_spans if s[0] in names])


def idle(trace: Trace) -> List[Interval]:
    """The body's intervals in which the device runs no operation: the
    gap loop of ``Trace.breakdown`` (``lib/trace.py``) again.  When that
    file next changes, ``Trace`` should give these intervals and both
    use them."""
    out, at = [], trace.start_ns
    for a, b in union(trace.device_ops) + [(trace.end_ns, trace.end_ns)]:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    return out


def overlap_ns(xs: Sequence[Interval], ys: Sequence[Interval]) -> int:
    """Nanoseconds covered by both of two sorted, disjoint lists."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def stall_ms(trace: Optional[Trace], name: str, n) -> Optional[float]:
    """Milliseconds over ``n`` (requests, steps) in which the device was
    idle while the host was inside a span called ``name``: the part of
    each idle interval that the spans overlap, not the gaps that began
    in one."""
    spans = named(trace, name) if trace is not None else []
    if not spans or not n:
        return None
    return overlap_ns(idle(trace), spans) / 1e6 / n
