"""Synthetic mini-ASVspoof2019-LA corpus (own copy of
``aasist_tpu/data/synthetic.py``: the same seed gives the same tree, byte
for byte).

It has the real corpus's on-disk layout (protocol files, per-split
``flac/`` directories, an ASV score file), so the whole score -> EER /
t-DCF pipeline runs in tests and on the card without the corpus.  The
e2e goldens were scored on it: seed 77 with 4/4/48 utterances in FLAC
(``tests/goldens/e2e_differential_golden.npz``) and seed 99 with 2/2/512 in
WAV (``e2e_diff_big_*.npz``).

Bonafide utterances are harmonic tones + noise; spoofed ones add AM
modulation and a high-frequency band per "attack id".
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List

import numpy as np

from aasist_tpu_torch.data.audio_io import write_wav

SR = 16000


def _synth_wave(rng: np.random.Generator, spoof: bool,
                duration_s: float) -> np.ndarray:
    n = int(duration_s * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 250)
    wave = np.zeros(n)
    for h in range(1, 6):
        wave += rng.uniform(0.2, 1.0) / h * np.sin(
            2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    wave += 0.02 * rng.standard_normal(n)
    if spoof:
        # AM buzz + high-frequency artifact band: an easy-to-learn cue
        wave *= 1.0 + 0.5 * np.sin(2 * np.pi * 50 * t)
        wave += 0.1 * np.sin(2 * np.pi * rng.uniform(6000, 7800) * t)
    wave /= max(1e-9, np.abs(wave).max())
    return (0.5 * wave).astype(np.float32)


def generate(root, n_train: int = 32, n_dev: int = 16, n_eval: int = 24,
             seed: int = 0, track: str = "LA",
             min_duration_s: float = 1.5,
             max_duration_s: float = 5.0,
             audio_format: str = "flac") -> Dict[str, List[str]]:
    """Create the fixture under ``root``; returns utt ids per split.

    ``audio_format="flac"`` (default) writes real FLAC through the port's
    pure-Python encoder, so that the native decoder is on the end-to-end
    path as with the real corpus; ``"wav"`` needs no native build.
    """
    rng = np.random.default_rng(seed)
    root = Path(root)
    proto_dir = root / f"ASVspoof2019_{track}_cm_protocols"
    proto_dir.mkdir(parents=True, exist_ok=True)
    ids: Dict[str, List[str]] = {}

    split_cfg = {
        "train": (n_train, "T", f"ASVspoof2019.{track}.cm.train.trn.txt"),
        "dev": (n_dev, "D", f"ASVspoof2019.{track}.cm.dev.trl.txt"),
        "eval": (n_eval, "E", f"ASVspoof2019.{track}.cm.eval.trl.txt"),
    }
    for split, (n, tag, proto_name) in split_cfg.items():
        flac_dir = root / f"ASVspoof2019_{track}_{split}" / "flac"
        flac_dir.mkdir(parents=True, exist_ok=True)
        lines = []
        ids[split] = []
        for i in range(n):
            spoof = (i % 2 == 1)
            utt = f"{track}_{tag}_{seed:02d}{i:05d}"
            spk = f"{track}_{1000 + i % 7}"
            dur = rng.uniform(min_duration_s, max_duration_s)
            wave = _synth_wave(rng, spoof, dur)
            if audio_format == "flac":
                from aasist_tpu_torch.data.flac_encode import write_flac
                pcm = np.clip(np.round(wave * 32768.0), -32768,
                              32767).astype(np.int64)
                write_flac(flac_dir / f"{utt}.flac", pcm, SR)
            else:
                write_wav(flac_dir / f"{utt}.wav", wave, SR)
            src = f"A{rng.integers(7, 20):02d}" if spoof else "-"
            key = "spoof" if spoof else "bonafide"
            lines.append(f"{spk} {utt} - {src} {key}")
            ids[split].append(utt)
        (proto_dir / proto_name).write_text("\n".join(lines) + "\n")

    # ASV score file: targets high, nontargets low, spoofs in between
    asv_dir = root / f"ASVspoof2019_{track}_asv_scores"
    asv_dir.mkdir(parents=True, exist_ok=True)
    asv_lines = []
    for i in range(200):
        asv_lines.append(f"spk{i} target {rng.normal(3.0, 1.0):.6f}")
        asv_lines.append(f"spk{i} nontarget {rng.normal(-3.0, 1.0):.6f}")
        asv_lines.append(f"spk{i} spoof {rng.normal(0.0, 1.5):.6f}")
    asv_path = asv_dir / f"ASVspoof2019.{track}.asv.eval.gi.trl.scores.txt"
    asv_path.write_text("\n".join(asv_lines) + "\n")
    return ids
