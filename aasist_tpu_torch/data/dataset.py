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
