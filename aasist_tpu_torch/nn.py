"""Primitives shared by the port's layers, in eval and in train mode.

Counterpart of ``aasist_tpu/nn.py``.  Layers are ``torch.nn`` modules whose
parameters keep the JAX package's (= the PyTorch reference's) layouts, so
weights carry across by name.  The convolutions are ``nn.Conv2d`` /
``F.conv1d``: every padding on the AASIST path is symmetric.

Random draws come from explicit ``torch.Generator`` objects.  A train-mode
forward takes an ``RngStream``, the counterpart of the JAX package's: each
dropout (and each other draw of the forward) takes the next generator of
the stream, so the draws of a step depend only on the stream's key, never
on the generators' state elsewhere.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5       # torch BatchNorm default, as in the JAX package


def batch_norm(bn: torch.nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               axis: int) -> torch.Tensor:
    """BatchNorm over ``axis`` with ``bn``'s parameters, in its mode: in
    eval mode with the running statistics; in train mode with the batch's,
    updating the running ones as the module's own forward does (momentum
    0.1, unbiased running variance: the JAX package's
    ``batch_norm(train=True)``; ``momentum=None`` averages cumulatively).

    ``axis`` lets one helper serve the NCHW trunk (axis 1) and the
    (B, N, D) graph layers (axis -1), whatever the module's rank.
    """
    factor = 0.0
    if bn.training:
        bn.num_batches_tracked.add_(1)
        factor = (1.0 / float(bn.num_batches_tracked) if bn.momentum is None
                  else bn.momentum)
    y = F.batch_norm(x.movedim(axis, 1), bn.running_mean, bn.running_var,
                     bn.weight, bn.bias, training=bn.training,
                     momentum=factor, eps=bn.eps)
    return y.movedim(1, axis)


def max_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Max pool over the trailing ``len(window)`` dims (NCL or NCHW), VALID
    padding (floor), stride equal to the window."""
    pool = F.max_pool1d if len(window) == 1 else F.max_pool2d
    return pool(x, tuple(window))


# torch's SELU constants equal jax.nn.selu's (alpha 1.6732632423543772,
# scale 1.0507009873554805)
selu = torch.selu


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with torch's scaling (kept rows divided by 1 - p),
    the keep mask drawn from ``generator`` (on ``x``'s device).
    ``F.dropout`` takes no generator, hence this."""
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


def generator_for(key: Sequence[int], device) -> torch.Generator:
    """A generator on ``device`` seeded from the integer tuple ``key``
    through numpy's ``SeedSequence``: equal keys, equal draws, on any
    device; no device work."""
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed[0]) << 31 | int(seed[1]) >> 1)
    return g


class RngStream:
    """Deterministic stream of generators for one train-mode forward.

    ``next(device)`` returns a generator seeded from ``key + (i,)`` for the
    stream's i-th draw, or ``None`` for a stream without a key.
    ``dropout_enabled=False`` turns every ``stream_dropout`` of the stream
    into the identity and still advances the count, so the other draws
    (frequency masking, input noise) are the same either way; the
    train-mode differentials run so (the reference's goldens were captured
    with every ``nn.Dropout`` at p = 0 and BatchNorm in train mode).
    """

    def __init__(self, key: Optional[Sequence[int]],
                 dropout_enabled: bool = True):
        self.key: Optional[Tuple[int, ...]] = (
            None if key is None else tuple(int(k) for k in key))
        self.dropout_enabled = dropout_enabled
        self.count = 0

    def next(self, device) -> Optional[torch.Generator]:
        self.count += 1
        if self.key is None:
            return None
        return generator_for(self.key + (self.count,), device)


def stream_dropout(rngs: Optional[RngStream], x: torch.Tensor, p: float,
                   train: bool) -> torch.Tensor:
    """Dropout drawing its generator from ``rngs``; the identity in eval
    mode and for p = 0.  An enabled train-mode dropout needs a stream with
    a key."""
    if not train or p == 0.0:
        return x
    if rngs is None:
        raise ValueError("dropout in train mode needs an RngStream")
    g = rngs.next(x.device)
    if not rngs.dropout_enabled:
        return x
    if g is None:
        raise ValueError("dropout in train mode needs an RngStream with a "
                         "key")
    return dropout(x, p, g)
