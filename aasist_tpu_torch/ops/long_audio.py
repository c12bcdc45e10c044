"""Long-audio scoring: strided fixed-length windows, scores aggregated per
utterance (own numpy copy of ``aasist_tpu/ops/long_audio.py``).

Audio beyond the 64,600-sample eval window is covered by windows at a hop
of half a window; the last window is right-aligned so the tail is always
scored, and audio shorter than the window is tile-repeated as in eval.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np

from aasist_tpu_torch.parallel.mesh import pad_batch_to_multiple
from aasist_tpu_torch.utils.dispatch import pipelined

WINDOW = 64600


def window_count(n_samples: int, window: int = WINDOW,
                 hop: int = WINDOW // 2) -> int:
    if n_samples <= window:
        return 1
    return 1 + -(-(n_samples - window) // hop)


def make_windows(x: np.ndarray, window: int = WINDOW,
                 hop: int = WINDOW // 2) -> np.ndarray:
    """(n,) waveform -> (n_windows, window) matrix."""
    n = x.shape[0]
    if n <= window:
        reps = window // n + 1
        return np.tile(x, reps)[None, :window]
    starts = [i * hop for i in range(window_count(n, window, hop) - 1)]
    starts.append(n - window)
    return np.stack([x[s:s + window] for s in starts])


def score_long_audio(
    waveforms: Sequence[np.ndarray],
    dispatch: Callable[[np.ndarray], Any],
    drain: Callable[[Any], np.ndarray],
    *,
    window: int = WINDOW,
    hop: int = WINDOW // 2,
    batch_size: int = 64,
    aggregate: str = "mean",
) -> List[float]:
    """Score utterances of any length.

    ``dispatch`` queues the scoring of (batch_size, window) float32 rows and
    returns a ticket; ``drain`` waits for a ticket and returns its
    batch_size scores (the Scorer passes its two steps; a synchronous
    scorer passes itself and ``np.asarray``).  Windows of all utterances
    are packed into fixed-size batches, the tail batch padded by repeating
    its last row, as the reference does, so the scorer sees one shape.
    Calls are pipelined two deep (``utils/dispatch.py``).
    """
    agg = {"mean": np.mean, "max": np.max, "min": np.min}[aggregate]
    all_windows = []
    spans: List[Tuple[int, int]] = []
    for x in waveforms:
        w = make_windows(np.asarray(x), window, hop)
        spans.append((len(all_windows), len(all_windows) + len(w)))
        all_windows.extend(w)
    windows = np.stack(all_windows).astype(np.float32)

    scores = np.empty(len(windows), np.float64)

    def dispatch_batch(i):
        # repeat-last-row padding shared with the mesh layer
        chunk, n = pad_batch_to_multiple(windows[i:i + batch_size],
                                         batch_size)
        return dispatch(chunk), i, n

    def drain_batch(ticket):
        out, i, n = ticket
        scores[i:i + n] = np.asarray(drain(out))[:n]

    pipelined(range(0, len(windows), batch_size), dispatch_batch,
              drain_batch)
    return [float(agg(scores[a:b])) for a, b in spans]
