"""Read the reference-format JSON ``configs/*.conf``.

Own copy of the part of ``aasist_tpu/config.py`` that scoring needs: the
``model_config`` block and ``model_path``.  The training and evaluation
keys come with their slices.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Union


@dataclasses.dataclass
class ExperimentConfig:
    model_config: Dict[str, Any]
    model_path: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        return cls(model_config=dict(d.get("model_config", {})),
                   model_path=d.get("model_path", ""))


def resolve_config_path(path: Union[str, Path]) -> Path:
    """Resolve a config path: as given, else ``NAME[.conf]`` in the
    checkout's ``configs/``."""
    p = Path(path)
    if p.exists():
        return p
    configs = Path(__file__).resolve().parent.parent / "configs"
    candidate = configs / (p.name if p.suffix else p.name + ".conf")
    if candidate.exists():
        return candidate
    raise FileNotFoundError(
        f"config {path!r} not found (also tried {candidate})")


def load_config(path: Union[str, Path]) -> ExperimentConfig:
    with open(resolve_config_path(path), "r") as f:
        return ExperimentConfig.from_dict(json.loads(f.read()))
