"""The FLAC decoder's speed (counterpart of ``tools/bench_decode.py``).

The best of 5 passes over a directory of ``.flac`` files through
``data/audio_io.py:read_audio`` (the native decoder's float64 path; the
loader's one-pass float32 path, ``flac_native.read_flac_f32``, is faster),
in ms a file.  It runs on the host.  Host timings spread by 10-15 % from run
to run on a shared machine: compare best-of numbers, taken back to back.

    python -m aasist_tpu_torch.tools.bench_decode FLAC_DIR [reps]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

PASSES = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("flac_dir", help="a directory of .flac files, e.g. an "
                                     "LA corpus's ASVspoof2019_LA_eval/flac")
    ap.add_argument("reps", type=int, nargs="?", default=40)
    args = ap.parse_args(argv)

    from aasist_tpu_torch.data.audio_io import read_audio

    files = sorted(Path(args.flac_dir).glob("*.flac"))
    if not files:
        raise SystemExit(f"no .flac files under {args.flac_dir}: make a "
                         "corpus with aasist_tpu_torch.data.synthetic first")
    for f in files[:4]:
        read_audio(f)
    best = float("inf")
    for _ in range(PASSES):
        t0 = time.perf_counter()
        n = 0
        for _ in range(args.reps):
            for f in files:
                read_audio(f)
                n += 1
        best = min(best, (time.perf_counter() - t0) / n)
    print(f"{1e3 * best:.3f} ms/file  {1 / best:.0f} files/s/core "
          f"({len(files)} files x {args.reps} reps, best of {PASSES})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
