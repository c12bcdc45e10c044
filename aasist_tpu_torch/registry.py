"""Model registry: a model is chosen by ``model_config["architecture"]``.

Counterpart of ``aasist_tpu/registry.py``, with its names:
  * ``AASIST``            (AASIST.conf, AASIST-L.conf, AASIST2.conf)
  * ``AASIST2``           (alias: AASIST with the Res2Net encoder forced)
  * ``AASIST_Robust``     (AASIST-Robust.conf)
  * ``RawNet2Spoof``      (RawNet2_baseline.conf)
  * ``RawNetGatSpoofST``  (RawGATST_baseline.conf)
Every model is built in eval mode with random weights: load them with
``weights.load_npz`` or ``utils/torch_compat.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def _aasist(cfg):
    from aasist_tpu_torch.models.aasist import AasistModel
    return AasistModel(cfg)


def _aasist2(cfg):
    cfg = dict(cfg)
    cfg.setdefault("encoder", "res2net")
    return _aasist(cfg)


def _robust(cfg):
    from aasist_tpu_torch.models.aasist_robust import AasistRobustModel
    return AasistRobustModel(cfg)


def _rawnet2(cfg):
    from aasist_tpu_torch.models.rawnet2 import RawNet2Model
    return RawNet2Model(cfg)


def _rawgat(cfg):
    from aasist_tpu_torch.models.rawgat_st import RawGatStModel
    return RawGatStModel(cfg)


_REGISTRY: Dict[str, Callable[[Dict[str, Any]], torch.nn.Module]] = {
    "AASIST": _aasist, "AASIST2": _aasist2, "AASIST_Robust": _robust,
    "RawNet2Spoof": _rawnet2, "RawNetGatSpoofST": _rawgat}


def list_architectures() -> List[str]:
    return sorted(_REGISTRY)


def build_model(model_config: Dict[str, Any]) -> torch.nn.Module:
    """Instantiate the architecture named in ``model_config``."""
    arch = model_config["architecture"]
    try:
        builder = _REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown architecture {arch!r}; valid: "
                       f"{list_architectures()}") from None
    return builder(model_config)
