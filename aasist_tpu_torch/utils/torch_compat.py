"""Carry a reference PyTorch ``state_dict`` (``.pth``) into the port's
models (counterpart of ``aasist_tpu/utils/torch_compat.py``).

The port keeps the reference's parameter names and layouts, so conversion
is a key-for-key copy:

  * ``encoder.{i}.0.*``, ``encoder_T.{i}.0.*``, ``encoder_S.{i}.0.*`` and
    ``block{i}.0.*`` lose the ``.0``: the reference wraps each encoder
    block in a one-element ``nn.Sequential``;
  * ``num_batches_tracked`` is dropped (never used in the math);
  * everything else, BatchNorm's ``running_mean`` / ``running_var``
    included, lands on the model tensor of the same name.

Loading is strict both ways: a checkpoint tensor with no home in the model
raises ``KeyError`` (``strict``), and a model tensor the checkpoint leaves
at its random initialisation raises ``ValueError``, unless its dotted name
starts with one of ``allow_unfilled`` (a head the reference's checkpoint
lacks).  ``convert_checkpoint`` also writes the ``.npz`` of
``checkpoints/``.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence

import numpy as np
import torch

_SEQ_WRAPPER = re.compile(r"^(encoder(?:_[ST])?\.\d+|block\d+)\.0\.")


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """A ``.pth`` state dict as numpy arrays (tensors only, no pickled
    code: ``weights_only``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().numpy() for k, v in sd.items()}


def fill_from_state_dict(model: torch.nn.Module,
                         sd: Dict[str, np.ndarray], strict: bool = True,
                         allow_unfilled: Sequence[str] = ()
                         ) -> torch.nn.Module:
    """Fill ``model`` in place from a reference state dict; returns it."""
    targets = {k: v for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    filled = set()
    with torch.no_grad():
        for key, value in sd.items():
            if key.endswith("num_batches_tracked"):
                continue
            key = _SEQ_WRAPPER.sub(r"\1.", key)
            if key not in targets:
                if strict:
                    raise KeyError(f"checkpoint key {key!r} has no home in "
                                   "the model")
                continue
            value = np.asarray(value)
            if tuple(targets[key].shape) != value.shape:
                raise ValueError(
                    f"shape mismatch for {key!r}: model "
                    f"{tuple(targets[key].shape)} vs checkpoint "
                    f"{value.shape}")
            targets[key].copy_(torch.from_numpy(np.array(value)))
            filled.add(key)
    unfilled = sorted(
        k for k in targets if k not in filled
        and not any(k == a or k.startswith(a + ".") for a in allow_unfilled))
    if unfilled:
        raise ValueError(
            "checkpoint left model tensors at their random initialisation "
            f"({len(unfilled)}): {unfilled[:20]}"
            + (" ..." if len(unfilled) > 20 else "")
            + " — pass allow_unfilled=[...] for genuinely new heads")
    return model


def convert_checkpoint(model: torch.nn.Module, pth_path, npz_path=None
                       ) -> torch.nn.Module:
    """Fill ``model`` from a reference ``.pth``; with ``npz_path``, also
    write its weights there in the layout of ``checkpoints/*.npz``."""
    fill_from_state_dict(model, load_torch_state_dict(pth_path))
    if npz_path is not None:
        from aasist_tpu_torch.weights import save_npz
        save_npz(model, npz_path)
    return model
