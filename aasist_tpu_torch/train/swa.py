"""Stochastic weight averaging (counterpart of ``aasist_tpu/train/swa.py``).

The reference (torchcontrib's SWA in manual mode) snapshots the weights on
every new best-dev epoch, averages the snapshots at the end, and then
re-estimates the BatchNorm statistics with a pass over the training
batches.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from aasist_tpu_torch import nn


class SWAState:
    """Running mean of parameter dicts: avg_{n+1} = avg_n n / (n + 1) +
    w / (n + 1), on the parameters' device, in their dtype."""

    def __init__(self):
        self.n: int = 0
        self.avg: Optional[Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor]) -> None:
        if self.avg is None:
            self.avg = {k: v.detach().clone() for k, v in params.items()}
        else:
            n = self.n
            for k, a in self.avg.items():
                a.mul_(n / (n + 1)).add_(params[k].detach(), alpha=1 / (n + 1))
        self.n += 1


@torch.no_grad()
def reestimate_bn_stats(model: torch.nn.Module, batches: Iterable, *,
                        max_batches: Optional[int] = None,
                        mixed_precision: bool = False) -> None:
    """Recompute every BatchNorm's running statistics under the model's
    current weights, in place (torchcontrib's ``bn_update``): each
    statistic becomes the mean over ``batches`` of that batch's own.

    The model runs in train mode over ``batches`` (``(x, ...)`` tuples or
    bare ``x``, moved to the model's device) with batch i's dropouts drawn
    from the stream keyed (0, i), every BatchNorm at momentum 1 so that a
    forward leaves its batch's statistics, which are averaged in f32; the
    modes and momenta are restored after.  ``mixed_precision`` runs the
    forwards as the bf16 train step does (``train/loop.py:forward_fn``), so
    each batch's statistics are bf16 values, and the average stays f32, as
    the JAX package's ``reestimate_bn_stats`` does.
    """
    from aasist_tpu_torch.train.loop import forward_fn

    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    momenta = [bn.momentum for bn in bns]
    stats = [b for bn in bns for b in (bn.running_mean, bn.running_var)]
    was_training = model.training
    device = next(model.parameters()).device
    run = forward_fn(model, mixed_precision)
    avg = [torch.zeros_like(b) for b in stats]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = 1.0
    model.train()
    try:
        n = 0
        for i, batch in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            x = torch.as_tensor(x).to(device, non_blocking=True)
            run(x, nn.RngStream((0, i)), False)
            n += 1
            for a, b in zip(avg, stats):
                a.add_(b - a, alpha=1 / n)
        if n:
            for a, b in zip(avg, stats):
                b.copy_(a)
    finally:
        for bn, m in zip(bns, momenta):
            bn.momentum = m
        model.train(was_training)
