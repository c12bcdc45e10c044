"""Eval-mode primitives shared by the port's layers.

Counterpart of ``aasist_tpu/nn.py``.  Layers are ``torch.nn`` modules whose
parameters keep the JAX package's (= the PyTorch reference's) layouts, so
weights carry across by name.  The convolutions are ``nn.Conv2d`` /
``F.conv1d``: every padding on the AASIST path is symmetric.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

BN_EPS = 1e-5       # torch BatchNorm default, as in the JAX package


def batch_norm(bn: torch.nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               axis: int) -> torch.Tensor:
    """Eval BatchNorm over ``axis`` with the running statistics.

    One ``F.batch_norm`` pass; ``axis`` lets one helper serve the NCHW
    trunk (axis 1) and the (B, N, D) graph layers (axis -1).
    """
    y = F.batch_norm(x.movedim(axis, 1), bn.running_mean, bn.running_var,
                     bn.weight, bn.bias, training=False, eps=BN_EPS)
    return y.movedim(1, axis)


def max_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Max pool over the trailing ``len(window)`` dims (NCL or NCHW), VALID
    padding (floor), stride equal to the window."""
    pool = F.max_pool1d if len(window) == 1 else F.max_pool2d
    return pool(x, tuple(window))


# torch's SELU constants equal jax.nn.selu's (alpha 1.6732632423543772,
# scale 1.0507009873554805)
selu = torch.selu
