"""Carry the JAX package's parameter trees into the port's modules, and
write a module's weights back in their layout (``checkpoints/*.npz``).

The port's parameter and buffer names are the JAX tree paths joined by '.',
with BatchNorm's ``mean``/``var`` state named ``running_mean``/
``running_var``.  Loading is strict both ways: every checkpoint leaf must
land on a tensor of the same shape, and every parameter and persistent
buffer of the module must be filled (torch's ``num_batches_tracked``
counters, which have no JAX counterpart, excepted).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from aasist_tpu_torch.utils.pytree_io import (flatten_tree, load_tree_npz,
                                              save_tree_npz)

_STATE_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {k.replace("/", "."): v for k, v in flatten_tree(tree).items()}


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


def jax_trees(model: torch.nn.Module) -> Tuple[Dict[str, Any],
                                               Dict[str, Any]]:
    """``model``'s (params, state) as the JAX package's nested trees of
    numpy arrays, each in its tensor's type (bfloat16 and float16, which
    numpy lacks, as float32): BatchNorm statistics under ``state`` as
    ``mean`` / ``var``, everything else under ``params``;
    ``num_batches_tracked`` dropped."""
    names = {v: k for k, v in _STATE_NAMES.items()}
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        *path, leaf = key.split(".")
        node = state if leaf in names else params
        for p in path:
            node = node.setdefault(p, {})
        value = value.detach().cpu()
        if value.dtype in (torch.bfloat16, torch.float16):
            value = value.float()
        node[names.get(leaf, leaf)] = value.numpy()
    return params, state


def save_npz(model: torch.nn.Module, path) -> None:
    """Write ``model``'s weights in the layout of ``checkpoints/*.npz``,
    which ``load_npz`` and the JAX package's ``load_tree_npz`` read."""
    save_tree_npz(path, *jax_trees(model))
