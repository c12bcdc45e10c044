"""The one generator that every traffic mix's data file drives.

A mix (``portbench/traffic/<name>.json``) gives parameters only:

  kind          "score" (calls into the Scorer) or "train" (train steps)
  lengths       utterance lengths in seconds: a log-normal of ``median_s``
                and ``sigma``, clipped to [``min_s``, ``max_s``]
  gain          per-utterance amplitude, log-uniform in [``min``, ``max``]
  pool          utterances made once in set-up and reused (score)
  request_sizes utterances a call; each block of that many calls takes
                every size once, in an order drawn from the seed (score)
  arrivals      {"loop": "closed"}: each call as soon as the last returned;
                {"loop": "open", "rate_per_s": r, "gaps": "fixed"}: calls
                due every 1 / r seconds (score)
  corpus        utterances written as 16-bit WAV, ``bonafide_share`` of
                them labelled bonafide (train)
  check_sample  outputs of the window compared with the reference (score)

The seed permutes a fixed set: every seed gets the same lengths, gains,
sizes and labels (quantiles of the stated laws), in its own order, and
its own noise.  So two seeds do the same work.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000


def quantile_lengths(spec: Dict, n: int) -> np.ndarray:
    """The n lengths in samples at the (i + 0.5) / n quantiles of the
    clipped log-normal, in ascending order."""
    from statistics import NormalDist

    law = NormalDist(np.log(spec["median_s"]), spec["sigma"])
    secs = np.exp([law.inv_cdf((i + 0.5) / n) for i in range(n)])
    secs = np.clip(secs, spec["min_s"], spec["max_s"])
    return np.round(secs * SAMPLE_RATE).astype(np.int64)


def quantile_gains(spec: Dict, n: int) -> np.ndarray:
    lo, hi = np.log(spec["min"]), np.log(spec["max"])
    return np.exp(lo + (hi - lo) * (np.arange(n) + 0.5) / n)


def _noise(total: int, seed: int, device) -> torch.Tensor:
    """``total`` standard-normal samples from ``seed``, made on
    ``device`` in one call."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return torch.randn(total, generator=g, device=device)


def _utterances(spec: Dict, n: int, seed: int, device
                ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(lengths, waveforms): n float32 waveforms of the mix's lengths and
    gains, each its seed's permutation, noise made on ``device``."""
    rng = np.random.default_rng((seed, 1))
    lengths = rng.permutation(quantile_lengths(spec["lengths"], n))
    gains = rng.permutation(quantile_gains(spec["gain"], n))
    flat = _noise(int(lengths.sum()), seed, device).cpu().numpy()
    waves, at = [], 0
    for n_i, g_i in zip(lengths, gains):
        waves.append(flat[at:at + n_i] * np.float32(g_i))
        at += n_i
    return lengths, waves


def make_pool(spec: Dict, seed: int, device) -> List[np.ndarray]:
    """The score mix's pool of float32 waveforms."""
    return _utterances(spec, spec["pool"], seed, device)[1]


def requests(spec: Dict, seed: int) -> Iterator[np.ndarray]:
    """Pool indices of each call, without end.  A call of the pool's size
    takes the whole pool in a fresh order; a smaller one draws distinct
    utterances."""
    rng = np.random.default_rng((seed, 2))
    sizes = list(spec["request_sizes"])
    n = spec["pool"]
    while True:
        for k in rng.permutation(sizes):
            yield (rng.permutation(n) if k == n
                   else rng.choice(n, size=int(k), replace=False))


def due_times(spec: Dict) -> Iterator[float]:
    """Seconds from the window's start at which each call is due: None for
    a closed loop (each call as soon as the last returned)."""
    arr = spec["arrivals"]
    if arr["loop"] == "closed":
        return itertools.repeat(None)
    if arr["gaps"] != "fixed":
        raise ValueError(f"unknown gaps {arr['gaps']!r}")
    rate = float(arr["rate_per_s"])
    return (i / rate for i in itertools.count())


def make_corpus(spec: Dict, seed: int, device
                ) -> Tuple[List[str], List[np.ndarray], Dict[str, int]]:
    """The train mix's corpus: (utterance ids, 16-bit PCM arrays, labels
    (bonafide 1))."""
    n = spec["corpus"]["utterances"]
    _, waves = _utterances(spec, n, seed, device)
    pcm = [np.clip(np.round(w * 32768.0), -32768, 32767).astype("<i2")
           for w in waves]
    n_bona = int(round(spec["corpus"]["bonafide_share"] * n))
    labels = np.random.default_rng((seed, 4)).permutation(
        np.r_[np.ones(n_bona, np.int64), np.zeros(n - n_bona, np.int64)])
    ids = [f"PB_T_{i:07d}" for i in range(n)]
    return ids, pcm, {u: int(y) for u, y in zip(ids, labels)}


def write_wavs(directory: Path, ids: Sequence[str],
               pcm: Sequence[np.ndarray]) -> None:
    """Mono 16-bit 16 kHz RIFF files ``directory/<id>.wav``."""
    import struct

    directory.mkdir(parents=True, exist_ok=True)
    for utt, data in zip(ids, pcm):
        body = data.tobytes()
        head = (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
                + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, SAMPLE_RATE,
                                        2 * SAMPLE_RATE, 2, 16)
                + b"data" + struct.pack("<I", len(body)))
        (directory / f"{utt}.wav").write_bytes(head + body)
