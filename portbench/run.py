"""Run one cell of the port's benchmark once, and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and metrics are found by name from ``BENCHMARK.json``
(``lib/spec.py``).  The run sets up, measures for ``--seconds``, checks
the window's outputs against the plain reference, and prints as the last
line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, ``window`` (the work
counted in it, and how late an open loop's calls ran), with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit (also the last lines of standard error).

It exits non-zero with no result line when the workload is unknown, when
CUDA is unavailable or has fewer cards than the cell asks for, when the
program cannot be imported, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aasist_tpu")
PROGRAM = "aasist_tpu_torch"


def cache_dirs(root: Path) -> None:
    """Kernel and build caches at fixed paths inside the checkout (the
    program's nvcc libraries already go to ``build/aasist_tpu_torch/``)."""
    cache = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``aasist_tpu_torch`` is not ``aasist_tpu``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader reads: the trace, the window's
    counts and host readings, the configuration and the mix."""

    def __init__(self, cell, outcome):
        from portbench.lib import roofline

        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.trace = outcome.trace
        self.counts, self.host = outcome.counts, outcome.host
        self.roofline = roofline


def per_layer(cell, outcome) -> Dict[str, Dict]:
    from portbench.lib.spec import metric_reader

    ctx = Context(cell, outcome)
    out = {}
    for m in cell.per_layer:
        value = metric_reader(cell, m["name"])(ctx)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> Optional[str]:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def result(cell, outcome, trace: bool, card: Dict) -> Dict:
    from portbench.lib import compare

    ok, checks = compare.judge(outcome.readings, cell.limits)
    if trace:
        metrics = per_layer(cell, outcome)
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = dict(card, memory_peak_bytes=outcome.memory_peak_bytes)
    line = {"correct": bool(ok and outcome.failed == 0
                            and outcome.attempted > 0),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device,
            "window": outcome.counts}
    if trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s()
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.lib import spec

    try:
        cell = spec.load_cell(ROOT, args.workload)
    except spec.UnknownWorkload as e:
        print(f"portbench: {e.args[0]}", file=sys.stderr)
        return 2
    cache_dirs(ROOT)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {cards}", file=sys.stderr)
        return 1
    try:
        __import__(PROGRAM)
    except ImportError as e:
        print(f"portbench: the program {PROGRAM} cannot be imported: {e}",
              file=sys.stderr)
        return 1
    from portbench.lib.run import execute

    outcome = execute(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: loaded in the measuring process: {found}",
              file=sys.stderr)
        return 3
    card = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips}
    line = result(cell, outcome, bool(args.trace), card)
    line["card"] = power_limit()
    line["checks"] = line.pop("checks")
    print(f"portbench: {args.workload} seed {args.seed} on {line['card']}",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
