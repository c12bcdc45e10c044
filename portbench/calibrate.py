"""Readings that the output check's limits are set from, on the chip; not
run by the benchmark's own runs.

    python3 -m portbench.calibrate --workload <cell> --seeds S [S ...] \\
        [--seconds 3] [--control] [--rates R [R ...]]

For each seed, one run of the cell in this process with a short window
(``--seconds``), its check's readings as a JSON line: the lower readings.
With ``--control``, beside them the control's readings against the same
reference: a scoring cell's reference in fp8 (the step below its bfloat16)
on the sampled utterances; a training cell's reference with TF32 on (the
step below float32 with TF32 off), its planted fault (each batch's
second half left out of the loss), and the same reference with cuDNN's
algorithms picked by timing (round-off alone).  With ``--rates``, an
open-loop cell is instead run once at each rate, for the sweep that finds
its knee.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench.lib import compare, spec
from portbench.lib.run import execute
from portbench.reference import training as ref_train
from portbench.run import ROOT, cache_dirs


def controls(cell, kept, seed: int, device) -> dict:
    ref = cell.reference
    mc = cell.config["model_config"]
    if cell.traffic["kind"] == "score":
        low = ref.score_rows(kept["P"], kept["rows"], mc, device=device,
                             block=cell.config["serve"]["batch_size"],
                             q=ref.fp8)
        return {"control_fp8": compare.score_readings(low,
                                                      kept["reference"])}
    out = {}
    for name, kw in (("control_tf32", {"tf32_on": True}),
                     ("fault_half_batch", {"half_batch": True}),
                     ("rounding_cudnn_benchmark",
                      {"cudnn_benchmark": True})):
        got = ref_train.follow(ref, kept["P"], kept["data"], mc,
                               cell.config["train"], seed,
                               kept["steps_per_epoch"], device, **kw)
        out[name] = compare.train_readings(got, kept["reference"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--rates", type=float, nargs="*")
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cell = spec.load_cell(ROOT, args.workload)
    runs = ([(s, None) for s in args.seeds] if not args.rates
            else [(args.seeds[0], r) for r in args.rates])
    for seed, rate in runs:
        if rate is not None:
            cell.traffic["arrivals"]["rate_per_s"] = rate
        out = execute(cell, seed, args.seconds, False, device,
                      keep=args.control)
        line = {"workload": cell.name, "seed": seed, "rate_per_s": rate,
                "readings": out.readings, "end_to_end": out.end_to_end,
                "counts": out.counts, "attempted": out.attempted,
                "failed": out.failed,
                "memory_peak_bytes": out.memory_peak_bytes}
        if args.control:
            line.update(controls(cell, out.kept, seed, device))
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
