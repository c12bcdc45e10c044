"""The eval data loader's throughput (counterpart of
``tools/bench_loader.py``).

Drives ``data/dataset.py:EvalBatcher`` (threaded native FLAC decode, padding
to 64,600 samples, batch assembly) over the eval split of a corpus directory
and reports the best of 3 passes in utterances a second: the host-side
ceiling on how fast the eval pipeline can feed the card.  On a card each
batch then goes to it as ``train/loop.py:produce_scores`` sends it: written
into a pinned slot of a ``SlotRing``, copied without blocking, one
synchronise at the end of a pass; ``--device cpu`` stops at the host batch.

    python -m aasist_tpu_torch.tools.bench_loader LA_DIR [batch] [reps] \\
        [--device cuda|cpu]

``--device`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from aasist_tpu_torch.tools._common import card_line, tool_device

PASSES = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="LA corpus root (holds "
                                 "ASVspoof2019_LA_eval/flac)")
    ap.add_argument("batch", type=int, nargs="?", default=16)
    ap.add_argument("reps", type=int, nargs="?", default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from aasist_tpu_torch.data.dataset import AudioStore, EvalBatcher
    from aasist_tpu_torch.utils.dispatch import SlotRing, record

    device = tool_device("bench_loader", args.device)
    store = AudioStore(Path(args.root) / "ASVspoof2019_LA_eval")
    flac_dir = store.base_dir / "flac"
    ids = sorted(p.stem for p in flac_dir.glob("*.flac"))
    if not ids:
        raise SystemExit(f"no .flac under {flac_dir}")
    batcher = EvalBatcher(store, ids, batch_size=args.batch)
    ring = None

    def feed(x):
        """One host batch to the card through the next pinned slot."""
        nonlocal ring
        if ring is None:
            ring = SlotRing(3, x.shape, 1)
        slot = ring.acquire()
        slot.rows.numpy()[:] = x
        slot.rows.to(device, non_blocking=True)
        slot.events = [record(device)]

    def one_pass(reps: int) -> int:
        total = 0
        for _ in range(reps):
            for x, _utts, n in batcher:
                if device.type == "cuda":
                    feed(x)
                total += n
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return total

    one_pass(1)           # warm-up: page cache, thread pool, pinned slots
    best = 0.0
    for _ in range(PASSES):
        t0 = time.perf_counter()
        total = one_pass(args.reps)
        best = max(best, total / (time.perf_counter() - t0))
    where = (f"to the card, pinned, non-blocking  [{card_line()}]"
             if device.type == "cuda" else "host-side")
    print(f"{best:.0f} utt/s {where} ({len(ids)} utts x {args.reps} reps, "
          f"batch {args.batch}, best of {PASSES})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
