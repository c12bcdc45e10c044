"""Carry the JAX package's parameter trees into the port's modules.

The port's parameter and buffer names are the JAX tree paths joined by '.',
with BatchNorm's ``mean``/``var`` state named ``running_mean``/
``running_var``.  Loading is strict both ways: every checkpoint leaf must
land on a tensor of the same shape, and every parameter and persistent
buffer of the module must be filled (torch's ``num_batches_tracked``
counters, which have no JAX counterpart, excepted).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from aasist_tpu_torch.utils.pytree_io import load_tree_npz

_STATE_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def load_jax_params(model: torch.nn.Module, params: Any, state: Any
                    ) -> torch.nn.Module:
    """Fill ``model`` in place from JAX ``params``/``state`` trees (nested
    dicts and lists of numpy arrays); returns ``model``."""
    flat = _flatten(params)
    for key, value in _flatten(state).items():
        head, dot, leaf = key.rpartition(".")
        flat[head + dot + _STATE_NAMES.get(leaf, leaf)] = value

    targets = {k: v for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    extra = sorted(set(flat) - set(targets))
    missing = sorted(set(targets) - set(flat))
    if extra or missing:
        raise KeyError(f"checkpoint and model disagree: leaves with no home "
                       f"in the model {extra[:10]}, model tensors the "
                       f"checkpoint does not fill {missing[:10]}")
    with torch.no_grad():
        for key, value in flat.items():
            target = targets[key]
            if tuple(target.shape) != value.shape:
                raise ValueError(f"shape mismatch for {key!r}: model "
                                 f"{tuple(target.shape)} vs checkpoint "
                                 f"{value.shape}")
            target.copy_(torch.from_numpy(np.array(value)))
    return model


def load_npz(model: torch.nn.Module, path) -> torch.nn.Module:
    """Fill ``model`` from a converted checkpoint (``checkpoints/*.npz``)."""
    return load_jax_params(model, *load_tree_npz(path))
