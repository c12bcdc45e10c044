"""Per-stage device time of the AASIST forward (counterpart of
``tools/profile_stages.py``).

Times cumulative cuts of the forward, each on the route the model takes:
the frontend, then blocks 0-5 one by one, then the full forward with the
graph stack; prints each cut's ms, each stage's difference and the
throughput from device time, with the card's name and power limit.

``--path`` picks the route through the model config's keys:
``frontend`` (``use_fused_frontend``: the tensor-core frontend kernel in
bf16, the Scorer's route with ``use_fused_stack=False``), ``stack``
(``use_fused_stack``, the Scorer's default in bf16 on a card: cut 0 is the
padded frontend store, cut 1 adds the block-0 kernel, whose channels-last
output the next blocks take as it is) or ``none`` (stock ops).  The cuts
run the model's own submodules (``frontend``, ``fused_stack``, the encoder
blocks).  Each cut reduces its output to one float32 sum on the device,
reading the tensor as it is laid out; a timed run is 2 warm-up calls, then
``--iters`` calls queued back to back between two CUDA events, ended by one
``.item()``.

    python -m aasist_tpu_torch.tools.profile_stages [B] [--path frontend|stack|none]
        [--dtype bfloat16|float32] [--iters 10] [--device cuda|cpu]

The batch defaults to 256 and the type to bfloat16; the weights are
``checkpoints/AASIST.npz``.  ``--device`` defaults to ``cuda`` and raises
without a card; on the CPU the times are the host's wall clock and the
kernels' plain versions run.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Callable, List, NamedTuple, Tuple

import torch

from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.tools._common import ROOT, card_line, tool_device
from aasist_tpu_torch.weights import load_npz

CONF = {
    "architecture": "AASIST",
    "first_conv": 128,
    "filts": [70, [1, 32], [32, 32], [32, 64], [64, 64]],
    "gat_dims": [64, 32],
    "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}
PATHS = ("frontend", "stack", "none")
NAMES = ("frontend", "block0", "block1", "block2", "block3", "block4",
         "block5")
N_WARMUP = 2
WINDOW = 64600        # samples an utterance, the eval window


class Cut(NamedTuple):
    name: str
    ms: float
    value: float          # the cut's sum, from the last timed call


def set_path(model: torch.nn.Module, path: str) -> None:
    """Route ``model`` as the config keys of ``path`` do."""
    if path not in PATHS:
        raise ValueError(f"path {path!r}: one of {PATHS}")
    model.use_fused_frontend = path == "frontend"
    model.use_fused_stack = path == "stack"


def cut(model: torch.nn.Module, upto: int) -> Callable:
    """x (B, L) -> the forward's output after ``upto`` encoder blocks
    (0: the frontend), on the route ``set_path`` gave ``model``."""
    from aasist_tpu_torch.models import layers as L
    from aasist_tpu_torch.ops.fused_stack import fused_frontend_padded

    def f(x: torch.Tensor) -> torch.Tensor:
        x, bank = L.model_input(model, x, None, False)
        if not model.use_fused_stack:
            h, blocks = model.frontend(x, bank), model.encoder[:upto]
        elif upto == 0:
            bn = model.first_bn
            return fused_frontend_padded(
                x, bank, {"weight": bn.weight, "bias": bn.bias},
                {"mean": bn.running_mean, "var": bn.running_var})
        else:
            h, blocks = model.fused_stack(x, bank), model.encoder[1:upto]
        for block in blocks:
            h = block(h)
        return h

    return f


def run_ms(fn: Callable, x: torch.Tensor, iters: int
           ) -> Tuple[float, float]:
    """(ms a call, the last call's value) of ``fn(x)``, a scalar tensor,
    over ``iters`` calls after N_WARMUP.  On a card: CUDA events around the
    queued calls, one ``.item()`` at the end; on the CPU the wall clock."""
    for _ in range(N_WARMUP):
        fn(x).item()
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(x)
        return 1e3 * (time.perf_counter() - t0) / iters, out.item()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn(x)
    end.record()
    value = out.item()
    end.synchronize()
    return start.elapsed_time(end) / iters, value


def profile(model: torch.nn.Module, x: torch.Tensor, path: str,
            iters: int = 10):
    """The cuts of ``model`` (eval, on x's device, in its dtype) on
    ``path``: ([Cut for the frontend, block0 .. block5, full], the full
    forward's logits from one more call)."""
    set_path(model, path)
    rows: List[Cut] = []
    with torch.inference_mode():
        for i, name in enumerate(NAMES):
            f = cut(model, i)
            rows.append(Cut(name, *run_ms(
                lambda xx: torch.sum(f(xx), dtype=torch.float32), x,
                iters)))
        rows.append(Cut("full", *run_ms(
            lambda xx: torch.sum(model(xx)[1], dtype=torch.float32), x,
            iters)))
        logits = model(x)[1]
    return rows, logits


def report(rows: List[Cut], batch: int, device_line: str) -> List[str]:
    """The printed lines: each cut's ms and its stage's difference, and the
    throughput from the full cut's time."""
    lines, prev = [], 0.0
    for r in rows:
        label = "graph stack" if r.name == "full" else "stage"
        lines.append(f"cum {r.name:9s}: {r.ms:9.3f} ms  ({label} "
                     f"{r.ms - prev:+9.3f} ms)  [{device_line}]")
        prev = r.ms
    lines.append(f"throughput   : {1e3 * batch / rows[-1].ms:9.1f} utt/s "
                 f"(device time, batch {batch})  [{device_line}]")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=256)
    ap.add_argument("--path", default="frontend", choices=PATHS)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    from aasist_tpu_torch.cli import full_f32

    device = tool_device("profile_stages", args.device)
    dtype = getattr(torch, args.dtype)
    model = load_npz(build_model(CONF), ROOT / "checkpoints" / "AASIST.npz")
    model = model.eval().to(device, dtype)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((args.batch, WINDOW), generator=gen, device=device)
    precision = full_f32 if args.dtype == "float32" else contextlib.nullcontext
    with precision():
        rows, _ = profile(model, x, args.path, args.iters)
    where = card_line() if device.type == "cuda" else "cpu, wall clock"
    print(f"AASIST {args.dtype}, path {args.path}, batch {args.batch}, "
          f"{args.iters} timed calls after {N_WARMUP}", flush=True)
    for line in report(rows, args.batch, where):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
