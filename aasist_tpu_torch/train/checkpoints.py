"""The full train state (counterpart of ``aasist_tpu/train/checkpoints.py``;
the weight snapshots ``weights/epoch_*.npz``, ``best.npz`` and
``swa.npz`` are ``weights.save_npz``'s files, in the JAX package's tree
layout, which the port's ``load_npz`` and the JAX package's
``load_tree_npz`` both read).

The train state is a directory: ``weights.npz`` (the same layout),
``opt_state.npz`` (the optimizer's per-parameter state, ``{parameter
name}/{state key}``), ``swa.npz`` (the SWA average by parameter name, when
there is one) and ``meta.json`` (step, epoch, best metrics, SWA count).
Saving is crash-safe: written to ``.tmp``, the previous state moved to
``.old``, the new one swapped in, ``.old`` deleted; a load that finds no
primary directory reads ``.old``.

The JAX package's ``orbax_compat.py`` is specific to JAX and has no
counterpart.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from aasist_tpu_torch import weights


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype in (torch.bfloat16, torch.float16)
            else t).numpy()


def save_train_state(directory, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, swa,
                     meta: Dict[str, Any]) -> None:
    """Write the train state crash-safely; ``meta`` holds step, epoch and
    the best metrics, to which the SWA count is added."""
    directory = Path(directory)
    tmp = directory.with_name(directory.name + ".tmp")
    old = directory.with_name(directory.name + ".old")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    weights.save_npz(model, tmp / "weights.npz")
    names = {p: n for n, p in model.named_parameters()}
    np.savez(tmp / "opt_state.npz", **{
        f"{names[p]}/{k}": _numpy(v)
        for p, st in optimizer.state.items() for k, v in st.items()})
    if swa.avg is not None:
        np.savez(tmp / "swa.npz", **{k: _numpy(v)
                                     for k, v in swa.avg.items()})
    (tmp / "meta.json").write_text(json.dumps(
        {**meta, "n_swa": swa.n, "has_swa": swa.avg is not None}))
    # clear .old only when a primary exists to take its place: after a
    # crash between the renames .old holds the only complete state
    if directory.exists():
        if old.exists():
            shutil.rmtree(old)
        os.replace(directory, old)
    os.replace(tmp, directory)
    if old.exists():
        shutil.rmtree(old)


def load_train_state(directory, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, swa
                     ) -> Dict[str, Any]:
    """Fill ``model``, ``optimizer`` and ``swa`` from a saved train state
    (or its ``.old`` copy); returns its ``meta``."""
    directory = Path(directory)
    if not directory.exists():
        old = directory.with_name(directory.name + ".old")
        if old.exists():
            directory = old
    meta = json.loads((directory / "meta.json").read_text())
    weights.load_npz(model, directory / "weights.npz")
    params = dict(model.named_parameters())
    optimizer.state.clear()
    with np.load(directory / "opt_state.npz") as data:
        for key in data.files:
            name, _, k = key.rpartition("/")
            p = params[name]
            v = torch.from_numpy(data[key])
            # Adam's step count stays a host tensor, as torch keeps it
            optimizer.state[p][k] = (v if k == "step"
                                     else v.to(p.device, p.dtype))
    swa.n = meta["n_swa"]
    swa.avg = None
    if meta.get("has_swa"):
        with np.load(directory / "swa.npz") as data:
            swa.avg = {k: torch.from_numpy(data[k]).to(
                params[k].device, params[k].dtype) for k in data.files}
    return meta
