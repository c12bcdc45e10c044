"""Real-data preflight for an ASVspoof2019-LA directory (counterpart of
``tools/preflight_la.py``).

The first half of going from a mounted corpus to the parity verdict in one
command: it checks the directory's layout end to end through the port's
own reader and prints the parity command.

Checks, per split (train / dev / eval):
  * the protocol file is present, parses, and its row count is printed
    beside the official LA counts (25380 / 24844 / 71237);
  * labels: both bonafide and spoof rows; eval carries attack ids (the
    per-attack EER breakdown needs them);
  * audio: every protocol utterance resolves under ``<split>/flac/``
    (``--sample N`` bounds the sweep; default all);
  * one utterance per split decodes through ``data/dataset.py:AudioStore``
    (the native FLAC decoder), with a plausible sample count.
Plus: the ASV score file exists and holds target, nontarget and spoof rows.

Exit 0 = ready; the tail prints::

    python -m aasist_tpu_torch.tools.verify_reference_parity --database_path <dir>

It runs on the host and takes no device::

    python -m aasist_tpu_torch.tools.preflight_la /path/to/LA [--sample 500]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, List

import numpy as np

# official ASVspoof2019-LA protocol row counts, for the report only
OFFICIAL_COUNTS = {"train": 25380, "dev": 24844, "eval": 71237}

PROTOCOLS = {
    "train": "ASVspoof2019.LA.cm.train.trn.txt",
    "dev": "ASVspoof2019.LA.cm.dev.trl.txt",
    "eval": "ASVspoof2019.LA.cm.eval.trl.txt",
}
AUDIO_DIRS = {
    "train": "ASVspoof2019_LA_train",
    "dev": "ASVspoof2019_LA_dev",
    "eval": "ASVspoof2019_LA_eval",
}
ASV_SCORES = os.path.join("ASVspoof2019_LA_asv_scores",
                          "ASVspoof2019.LA.asv.eval.gi.trl.scores.txt")


class Report:
    """One preflight's printed lines and its problems."""

    def __init__(self, out: Callable[[str], None] = print):
        self.out = out
        self.problems: List[str] = []

    def problem(self, msg: str) -> None:
        self.out(f"FAIL {msg}")
        self.problems.append(msg)

    def ok(self, msg: str) -> None:
        self.out(f"ok   {msg}")


def check_split(rep: Report, root: str, split: str, sample: int) -> None:
    from aasist_tpu_torch.data.dataset import AudioStore
    from aasist_tpu_torch.data.protocol import parse_protocol

    proto = os.path.join(root, "ASVspoof2019_LA_cm_protocols",
                         PROTOCOLS[split])
    if not os.path.isfile(proto):
        rep.problem(f"{split}: protocol missing: {proto}")
        return
    try:
        entries = parse_protocol(proto)
    except Exception as e:  # malformed lines
        rep.problem(f"{split}: protocol unparseable: {e}")
        return
    n = len(entries)
    official = OFFICIAL_COUNTS[split]
    note = ("matches official" if n == official
            else f"official LA has {official}")
    rep.ok(f"{split}: protocol {n} rows ({note})")

    n_bona = sum(1 for e in entries if e.key == "bonafide")
    n_spoof = n - n_bona
    if not n_bona or not n_spoof:
        rep.problem(f"{split}: need both classes, got bonafide={n_bona} "
                    f"spoof={n_spoof}")
    else:
        rep.ok(f"{split}: bonafide={n_bona} spoof={n_spoof}")
    if split == "eval":
        attacks = sorted({e.src for e in entries if e.key != "bonafide"})
        if not attacks:
            rep.problem("eval: no attack ids — per-attack EER breakdown "
                        "impossible")
        else:
            rep.ok(f"eval: attack ids {attacks[0]}..{attacks[-1]} "
                   f"({len(attacks)} systems)")

    audio_dir = os.path.join(root, AUDIO_DIRS[split])
    store = AudioStore(audio_dir)
    flac_dir = os.path.join(audio_dir, "flac")
    if not os.path.isdir(flac_dir):
        rep.problem(f"{split}: audio dir missing: {flac_dir}")
        return
    to_check = entries if sample <= 0 else entries[:sample]
    missing = []
    for e in to_check:
        if not (os.path.exists(os.path.join(flac_dir, e.utt_id + ".flac"))
                or os.path.exists(os.path.join(flac_dir,
                                               e.utt_id + ".wav"))):
            missing.append(e.utt_id)
            if len(missing) >= 5:
                break
    if missing:
        rep.problem(f"{split}: missing audio for {missing} "
                    f"(first {len(missing)} of a bounded sweep)")
    else:
        scope = "all" if sample <= 0 else f"first {len(to_check)}"
        rep.ok(f"{split}: audio present for {scope} protocol utterances")

    # one real decode through the eval pipeline's reader
    try:
        wave = store.read(entries[0].utt_id)
    except Exception as e:
        rep.problem(f"{split}: decode of {entries[0].utt_id} failed: {e}")
        return
    if wave.ndim != 1 or wave.size < 1600 or not np.isfinite(wave).all():
        rep.problem(f"{split}: decoded {entries[0].utt_id} looks wrong: "
                    f"shape={wave.shape} dtype={wave.dtype}")
    else:
        rep.ok(f"{split}: decoded {entries[0].utt_id}: {wave.size} samples "
               f"({wave.size / 16000:.2f}s) {wave.dtype}")


def check_asv(rep: Report, root: str) -> None:
    path = os.path.join(root, ASV_SCORES)
    if not os.path.isfile(path):
        rep.problem(f"ASV score file missing: {path}")
        return
    data = np.genfromtxt(path, dtype=str)
    if data.ndim != 2 or data.shape[1] < 2:
        rep.problem(f"ASV score file malformed: shape {data.shape}")
        return
    kinds = set(data[:, -2])
    needed = {"target", "nontarget", "spoof"}
    if not needed <= kinds:
        rep.problem(f"ASV score file lacks classes {needed - kinds}")
    else:
        rep.ok(f"ASV scores: {data.shape[0]} rows, classes {sorted(kinds)}")


def preflight(root: str, sample: int = 0,
              out: Callable[[str], None] = print) -> List[str]:
    """Check the LA directory ``root``, printing each line through ``out``;
    returns this call's problems (none: ready)."""
    rep = Report(out)
    if not os.path.isdir(root):
        rep.problem(f"not a directory: {root}")
    else:
        for split in ("train", "dev", "eval"):
            check_split(rep, root, split, sample)
        check_asv(rep, root)
    return rep.problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("database_path", help="LA root directory")
    ap.add_argument("--sample", type=int, default=0,
                    help="bound the audio-existence sweep to the first N "
                         "protocol rows per split (0 = all)")
    args = ap.parse_args(argv)

    root = args.database_path
    problems = preflight(root, args.sample)
    print()
    if problems:
        print(f"preflight FAILED ({len(problems)} problems) — fix the "
              "layout and rerun")
        return 1
    print("preflight PASSED — run the parity verdict with:")
    print(f"    python -m aasist_tpu_torch.tools.verify_reference_parity "
          f"--database_path {root}")
    print("(expected for the pretrained AASIST checkpoint: "
          "0.83% EER / 0.0275 min t-DCF, the reference's published numbers)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
