"""Run metrics: ``metrics.jsonl`` and ``metric_log.txt`` always, TensorBoard
where ``torch.utils.tensorboard`` imports (own copy of
``aasist_tpu/utils/logging.py``).

The JSON lines are the primary record, one ``{"t", "name", "value",
"step"}`` object a scalar; the text log takes the reference's free-form
lines (``metric_log.txt``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, run_dir, use_tensorboard: bool = True):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a")
        self._text = open(self.run_dir / "metric_log.txt", "a")
        self._text.write("=" * 5 + "\n")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:     # tensorboard is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(str(self.run_dir))

    def scalar(self, name: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"t": time.time(), "name": name, "value": float(value),
             "step": int(step)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def text(self, line: str) -> None:
        self._text.write(line + "\n")
        self._text.flush()

    def close(self) -> None:
        self._jsonl.close()
        self._text.close()
        if self._tb is not None:
            self._tb.close()
