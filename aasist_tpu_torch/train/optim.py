"""Optimizers and learning-rate schedules (counterpart of
``aasist_tpu/train/optim.py``).

The schedules are functions of the global step.  Cosine annealing and
keras decay step per batch; multistep and SGDR are per-epoch staircases,
``steps_per_epoch`` folding the epoch into the step (the reference steps
those two once an epoch).  The trainer sets the lr of step k to ``lr(k)``
before the step.

``torch.optim.Adam`` (L2 ``weight_decay`` added to the gradient, not AdamW;
``amsgrad`` from the config) and ``torch.optim.SGD`` (momentum, nesterov,
weight decay) are the reference's own optimizers.  A parameter whose
``.grad`` stays ``None`` is skipped by both: no moments, no decay.  The
discarded bn1 of the residual encoders relies on that (the JAX package
masks those leaves instead), so nothing in the trainer turns a ``None``
gradient into zeros.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

from aasist_tpu_torch.config import OptimConfig


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """lr(step) for the configured scheduler."""
    base = cfg.base_lr
    name = cfg.scheduler
    if name == "cosine":
        total = max(1, cfg.epochs * cfg.steps_per_epoch)
        lo = cfg.lr_min / base
        return lambda step: base * (lo + (1 - lo) * 0.5 * (
            1 + math.cos(step / total * math.pi)))
    if name == "keras_decay":
        return lambda step: base / (1.0 + cfg.keras_decay * step)
    if name == "multistep":
        # torch's MultiStepLR stepped once an epoch: base * lr_decay ** (the
        # milestones reached by the step's epoch)
        spe = max(1, cfg.steps_per_epoch)
        ms = sorted(int(m) for m in cfg.milestones)
        return lambda step: base * cfg.lr_decay ** sum(
            m <= step // spe for m in ms)
    if name == "sgdr":
        # warm restarts every T0 epochs, the period times Tmult each cycle;
        # within a cycle lr_min + (base - lr_min) (1 + cos(pi t / Ti)) / 2
        spe = max(1, cfg.steps_per_epoch)
        starts, tis = [0], [cfg.T0]
        while starts[-1] + tis[-1] < max(cfg.epochs, cfg.T0) * 2:
            starts.append(starts[-1] + tis[-1])
            tis.append(tis[-1] * max(1, cfg.Tmult))

        def sgdr(step):
            e = step // spe
            i = int(np.searchsorted(starts, e, side="right")) - 1
            return cfg.lr_min + (base - cfg.lr_min) * (
                1 + math.cos(math.pi * (e - starts[i]) / tis[i])) / 2
        return sgdr
    if name in (None, "", "none"):
        return lambda step: base
    raise ValueError(f"unknown scheduler {name!r}")


def create_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter]
                     ) -> torch.optim.Optimizer:
    """The config's optimizer over ``params``, at ``base_lr`` until the
    trainer sets each step's lr."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.base_lr,
                                betas=tuple(cfg.betas),
                                weight_decay=cfg.weight_decay,
                                amsgrad=cfg.amsgrad)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.base_lr,
                               momentum=cfg.momentum, nesterov=cfg.nesterov,
                               weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
