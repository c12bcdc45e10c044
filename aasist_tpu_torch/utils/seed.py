"""Reproducibility helper (own copy of ``aasist_tpu/utils/seed.py``).

Seeds Python's, NumPy's legacy global and PyTorch's generators for any
library code that draws from them.  The eval path draws nothing; the
seeded data of the port's tests and ``chip_smoke.py`` come from explicit
``np.random.Generator`` objects.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
