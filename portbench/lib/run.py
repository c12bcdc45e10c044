"""One run of one cell: set-up, the measured window, the output check.

``execute(cell, seed, seconds, trace, device)`` runs the driver of the
cell's traffic kind (``score.py`` or ``train.py``) and returns an
``Outcome``; ``portbench/run.py`` turns it into the result line.  Tests
call ``execute`` on the CPU with small cells of their own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from portbench.lib import trace as tr
from portbench.lib.spec import Cell


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]    # every end-to-end metric measured
    counts: Dict[str, float]        # work done in the window
    host: Dict[str, float]          # host-clock readings of layers
    readings: Dict[str, float]      # the output check's numbers
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[tr.Trace] = None
    kept: Dict[str, Any] = dataclasses.field(default_factory=dict)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, keep: bool = False) -> Outcome:
    kind = cell.traffic["kind"]
    if kind == "score":
        from portbench.lib import score as driver
    elif kind == "train":
        from portbench.lib import train as driver
    else:
        raise ValueError(f"traffic kind {kind!r}: score or train")
    return driver.run(cell, seed, seconds, trace, torch.device(device),
                      keep)


def peak_memory(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free(device: torch.device) -> None:
    """Give the program's memory back before the reference runs."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
