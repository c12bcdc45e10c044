"""How many of a profiler window's first kernel launches its trace loses,
as the process ages: the fault ``utils/profiling.trace``'s warm-up takes.

    python3 -m aasist_tpu_torch.tools.trace_launches

Every 50 s until the process is 220 s old it opens four windows, each
around 40 small PyTorch kernels launched 100 us apart, and counts the
kernels the Chrome trace holds: ``bare`` (a profiler window synchronised at
both ends, as ``trace`` was before its warm-up), ``pause`` (the bare window
with the body held back by the warm-up's time, no kernel in it),
``schedule`` (a profiler schedule with one warm-up step before the active
one) and ``trace`` itself.  One line a window.  A launch call with no
kernel event is an orphan; in ``trace`` windows the orphans are the
warm-up's kernels.

Exits non-zero if a ``trace`` window holds fewer kernels than launches.
"""

from __future__ import annotations

import contextlib
import json
import tempfile
import time
from pathlib import Path
from typing import Dict

from aasist_tpu_torch.tools import _common

EVERY_S = 50.0
UNTIL_S = 220.0


@contextlib.contextmanager
def _bare_window(log_dir, pause: float = 0.0):
    """A ``torch.profiler`` window as ``profiling.trace`` opened one before
    its warm-up: synchronised at both ends; the body after ``pause``
    seconds of sleep."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pause)
        yield prof
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _pause_window(log_dir):
    """The bare window with the body held back by ``profiling.warm_up_s``
    of sleep: no kernel in the pause."""
    from aasist_tpu_torch.utils import profiling

    return _bare_window(log_dir, profiling.warm_up_s(
        profiling.process_age_s()))


@contextlib.contextmanager
def _schedule_window(log_dir):
    """A profiler with one warm-up step (recording, then discarded) before
    its active step: the body runs in the active step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    y = torch.zeros(256, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(
                     str(Path(log_dir) / "trace.json"))) as prof:
        y.add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        yield prof
        torch.cuda.synchronize()
        prof.step()


WINDOWS = {"bare": _bare_window, "pause": _pause_window,
           "schedule": _schedule_window}


def dead_zone(log_dir, launches: int = 40, gap_us: float = 100.0,
              window: str = "trace") -> Dict[str, object]:
    """One window of ``launches`` small PyTorch kernels, one every
    ``gap_us`` us on the host's clock: which of them the trace holds
    (``profiling.trace``, or with ``bare`` a window with no margin).
    ``n_orphans``: the launch calls with no kernel event, from
    ``first_orphan_us`` to ``last_orphan_us`` after the window's start;
    ``first_found_us``: the first kernel held."""
    import torch

    from aasist_tpu_torch.utils import profiling

    y = torch.zeros(1 << 12, device="cuda")
    y.exp_()
    with WINDOWS.get(window, profiling.trace)(log_dir):
        for _ in range(launches):
            t = time.perf_counter() + gap_us * 1e-6
            y.exp_()
            while time.perf_counter() < t:
                pass
    res = profiling.read_trace(Path(log_dir) / "trace.json", "exp",
                               launches)
    starts = res["starts_us"]
    return {"found": res["found"], "launches": launches,
            "n_orphans": res["n_orphans"],
            "first_orphan_us": res["orphans_us"][:1],
            "last_orphan_us": res["orphans_us"][-1:],
            "first_found_us": starts[:1], "skew_us": res["skew_us"]}


def main() -> int:
    _common.need_card("trace_launches")
    from aasist_tpu_torch.utils import profiling

    start = time.monotonic()
    card = _common.card_line()
    short, i = False, 0
    with tempfile.TemporaryDirectory() as tmp:
        while profiling.process_age_s() <= UNTIL_S:
            for window in ("bare", "pause", "schedule", "trace"):
                res = dead_zone(Path(tmp) / f"dz{i}{window}", window=window)
                if window == "trace":
                    short |= res["found"] < res["launches"]
                print(f"[trace] {window} window at "
                      f"{profiling.process_age_s():.1f} s of the process: "
                      f"{json.dumps(res)}  [{card}]", flush=True)
            i += 1
            time.sleep(max(0.0, start + i * EVERY_S - time.monotonic()))
    return 1 if short else 0


if __name__ == "__main__":
    raise SystemExit(main())
