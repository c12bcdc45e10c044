"""Read the reference-format JSON ``configs/*.conf``.

Own copy of the part of ``aasist_tpu/config.py`` that scoring needs: the
``model_config`` block and ``model_path``.  The training and evaluation
keys come with their slices.  The stock configs ride along as package data
(``aasist_tpu_torch/configs/``), so ``load_config("AASIST")`` works from an
installed tree; a config's ``model_path`` is read relative to the working
directory, as the reference reads it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Union

# The stock configs, shipped as package data (copies of the checkout's
# configs/*.conf).
PACKAGED_CONFIGS = Path(__file__).resolve().parent / "configs"


@dataclasses.dataclass
class ExperimentConfig:
    model_config: Dict[str, Any]
    model_path: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        return cls(model_config=dict(d.get("model_config", {})),
                   model_path=d.get("model_path", ""))


def resolve_config_path(path: Union[str, Path]) -> Path:
    """Resolve a config path: as given, else the packaged copy of the stock
    config of that name under ``aasist_tpu_torch/configs/``, so that an
    installed tree needs no checkout.  Accepts ``configs/NAME.conf``,
    ``NAME.conf`` or ``NAME``, as ``aasist_tpu/config.py`` does."""
    p = Path(path)
    if p.exists():
        return p
    candidate = PACKAGED_CONFIGS / (p.name if p.suffix else p.name + ".conf")
    if candidate.exists():
        return candidate
    raise FileNotFoundError(
        f"config {path!r} not found (also tried packaged {candidate})")


def load_config(path: Union[str, Path]) -> ExperimentConfig:
    with open(resolve_config_path(path), "r") as f:
        return ExperimentConfig.from_dict(json.loads(f.read()))
