"""Model registry: a model is chosen by ``model_config["architecture"]``.

Counterpart of ``aasist_tpu/registry.py``.  This slice of the port has
AASIST (and AASIST-L, the same architecture at other widths); every other
name of the JAX zoo raises until its slice lands.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch


def list_architectures() -> List[str]:
    return ["AASIST"]


def build_model(model_config: Dict[str, Any]) -> torch.nn.Module:
    """Instantiate the architecture named in ``model_config`` (eval mode,
    random weights: load them with ``weights.load_npz``)."""
    arch = model_config["architecture"]
    if arch != "AASIST":
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to PyTorch yet (ported: "
            f"{list_architectures()}); see the port's queue in ROADMAP.md")
    from aasist_tpu_torch.models.aasist import AasistModel
    return AasistModel(model_config)
