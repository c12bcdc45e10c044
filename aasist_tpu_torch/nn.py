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

In a data-parallel run (``parallel/mesh.py``) a rank holds some rows of
each global batch.  A BatchNorm marked by ``sync_batch_norm`` takes its
train-mode statistics over every rank's rows, and a stream with a
``shard`` draws each mask over the global batch's shape and keeps the
rank's rows, so that the ranks together compute the one-process forward.
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
    (B, N, D) graph layers (axis -1), whatever the module's rank.  A
    module with ``dp_ranks`` (``parallel/mesh.py:sync_batch_norm``) takes
    its train-mode statistics over all ranks' rows.
    """
    factor = 0.0
    if bn.training:
        bn.num_batches_tracked.add_(1)
        factor = (1.0 / float(bn.num_batches_tracked) if bn.momentum is None
                  else bn.momentum)
        ranks = getattr(bn, "dp_ranks", None)
        if ranks is not None:
            return _global_batch_norm(bn, x, axis, factor, ranks)
    y = F.batch_norm(x.movedim(axis, 1), bn.running_mean, bn.running_var,
                     bn.weight, bn.bias, training=bn.training,
                     momentum=factor, eps=bn.eps)
    return y.movedim(1, axis)


def _global_batch_norm(bn, x: torch.Tensor, axis: int, factor: float,
                       ranks) -> torch.Tensor:
    """Train-mode BatchNorm over the rows of every rank: the mean, then the
    biased variance about it, each summed over the ranks by a
    differentiable all-reduce, in float32 at least (bf16 input as
    ``F.batch_norm`` computes it); the running variance is unbiased over
    the global count."""
    xm = x.movedim(axis, 1)
    acc = torch.promote_types(x.dtype, torch.float32)
    xa = xm.to(acc)
    dims = [d for d in range(xa.dim()) if d != 1]
    shape = [1, -1] + [1] * (xa.dim() - 2)
    count = torch.full((1,), xa.numel() // xa.shape[1], dtype=acc,
                       device=xa.device)
    sums = ranks.all_reduce(torch.cat([xa.sum(dims), count]))
    n = sums[-1]
    mean = sums[:-1] / n
    d = xa - mean.view(shape)
    var = ranks.all_reduce((d * d).sum(dims)) / n
    y = d * torch.rsqrt(var + bn.eps).view(shape)
    if bn.weight is not None:
        y = y * bn.weight.to(acc).view(shape) + bn.bias.to(acc).view(shape)
    with torch.no_grad():
        rm, rv = bn.running_mean, bn.running_var
        rm.copy_((1 - factor) * rm.to(acc) + factor * mean.detach())
        rv.copy_((1 - factor) * rv.to(acc)
                 + factor * var.detach() * n / (n - 1))
    return y.to(x.dtype).movedim(1, axis)


def global_std(x: torch.Tensor, ranks) -> torch.Tensor:
    """The population std of every element of every rank's ``x``, two
    passes, not differentiated."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xa = x.detach().to(acc).reshape(-1)
    sums = ranks.all_reduce(torch.stack([xa.sum(), torch.tensor(
        float(xa.numel()), dtype=acc, device=xa.device)]))
    mean = sums[0] / sums[1]
    var = ranks.all_reduce(((xa - mean) ** 2).sum()) / sums[1]
    return var.sqrt().to(x.dtype)


def max_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Max pool over the trailing ``len(window)`` dims (NCL or NCHW), VALID
    padding (floor), stride equal to the window."""
    pool = F.max_pool1d if len(window) == 1 else F.max_pool2d
    return pool(x, tuple(window))


# torch's SELU constants equal jax.nn.selu's (alpha 1.6732632423543772,
# scale 1.0507009873554805)
selu = torch.selu


def global_draw(shard, x: torch.Tensor, draw) -> torch.Tensor:
    """``draw(shape)`` at ``x``'s shape, or with a ``parallel/mesh.py:
    RowShard`` at the global batch's and cut to the shard's rows."""
    if shard is None:
        return draw(x.shape)
    return draw((shard.total, *x.shape[1:]))[shard.start:shard.stop]


def dropout(x: torch.Tensor, p: float, generator: torch.Generator,
            shard=None) -> torch.Tensor:
    """Inverted dropout with torch's scaling (kept rows divided by 1 - p),
    the keep mask drawn from ``generator`` (on ``x``'s device), over the
    global batch with a ``shard``.  ``F.dropout`` takes no generator,
    hence this."""
    keep = global_draw(shard, x, lambda shape: torch.empty(
        shape, dtype=x.dtype, device=x.device).bernoulli_(
            1.0 - p, generator=generator))
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
    ``shard`` (a ``parallel/mesh.py:RowShard``) is the rank's rows of the
    global batch in a data-parallel step: masks and noise are drawn over
    the global batch and cut to them.
    """

    def __init__(self, key: Optional[Sequence[int]],
                 dropout_enabled: bool = True, shard=None):
        self.key: Optional[Tuple[int, ...]] = (
            None if key is None else tuple(int(k) for k in key))
        self.dropout_enabled = dropout_enabled
        self.shard = shard
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
    return dropout(x, p, g, rngs.shard)
