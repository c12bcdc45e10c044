"""The weights of a configuration: read from a checkpoint file of the repo,
or made on the device from the run's seed.  Both sides of a run (the
program under test and the plain reference) get the same dict of float32
tensors, named as the checkpoints name them."""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import numpy as np
import torch

_STATE = {"mean": "running_mean", "var": "running_var"}


def load_checkpoint(path: Path, device) -> Dict[str, torch.Tensor]:
    """A flat ``.npz`` of ``params/...`` and ``state/...`` paths ('/'
    joined) as {dotted name: float32 tensor on ``device``}."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            kind, _, leaf_path = key.partition("/")
            name = leaf_path.replace("/", ".")
            if kind == "state":
                head, _, leaf = name.rpartition(".")
                name = f"{head}.{_STATE[leaf]}"
            out[name] = torch.from_numpy(np.array(data[key], np.float32))
    return {k: v.to(device) for k, v in out.items()}


def make(model, mc, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights of the reference ``model`` (a module of
    ``portbench/reference/`` with ``param_shapes``) from ``seed``, made on
    ``device`` by one generator in two
    draws over all leaves at once: LeCun-normal weights (std
    1/sqrt(fan-in)), small biases, BatchNorm near the identity with
    running statistics about 0 and 1, attention vectors xavier-normal,
    positional and master nodes standard normal."""
    shapes = model.param_shapes(mc)
    total = sum(math.prod(s) for s, _ in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    z = torch.randn(total, generator=g, device=device)
    u = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, (shape, kind) in shapes.items():
        n = math.prod(shape)
        zn, un = z[at:at + n].view(shape), u[at:at + n].view(shape)
        at += n
        if kind == "weight":
            t = zn / math.sqrt(math.prod(shape[1:]))
        elif kind == "att":
            t = zn * math.sqrt(2.0 / (shape[0] + 1))
        elif kind == "bias":
            t = 0.05 * zn
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * zn
        elif kind in ("bn_bias", "bn_mean"):
            t = 0.1 * zn
        elif kind == "bn_var":
            t = 0.5 + un
        else:
            t = zn
        out[name] = t.contiguous()
    return out


def of_config(src: str, model, mc, seed: int, device, root: Path
              ) -> Dict[str, torch.Tensor]:
    """A configuration's weights: ``"seed"`` makes them from the run's
    seed, ``"seed:<n>"`` from the seed n that the configuration states (one
    model for every run, as a checkpoint is), any other ``src`` is a
    checkpoint path under ``root``."""
    if src == "seed":
        return make(model, mc, seed, device)
    if src.startswith("seed:"):
        return make(model, mc, int(src[len("seed:"):]), device)
    return load_checkpoint(root / src, device)
