"""The eval padding policy (own copy of ``aasist_tpu/data/dataset.py``'s)."""

from __future__ import annotations

import numpy as np

FIXED_EVAL_LEN = 64600      # ~4.04 s at 16 kHz, the reference's eval window


def pad_to_fixed(x: np.ndarray, max_len: int = FIXED_EVAL_LEN) -> np.ndarray:
    """Crop, or tile-repeat then crop, to exactly ``max_len`` samples."""
    n = x.shape[0]
    if n >= max_len:
        return x[:max_len]
    reps = max_len // n + 1
    return np.tile(x, reps)[:max_len]


def pad_into(dst: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``pad_to_fixed(x, len(dst))`` written into the row ``dst`` with no
    intermediate array (the Scorer fills its pinned buffer with it)."""
    max_len, n = dst.shape[0], x.shape[0]
    if n >= max_len:
        dst[:] = x[:max_len]
        return dst
    dst[:n] = x
    done = n
    while done < max_len:                  # double the repeated prefix
        k = min(done, max_len - done)
        dst[done:done + k] = dst[:k]
        done += k
    return dst
