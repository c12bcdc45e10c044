"""Read the reference-format JSON ``configs/*.conf``.

Own copy of the part of ``aasist_tpu/config.py`` that scoring and
evaluation need: the ``model_config`` block, ``model_path``, the dataset
paths and the run-directory keys.  Every other key (the optimiser's, the
loss's, ``eval_batch_size``, ``eval_chain``) is kept verbatim in
``extras``; the training keys get their own fields with the training
slice.  The stock configs ride along as package data
(``aasist_tpu_torch/configs/``), so ``load_config("AASIST")`` works from an
installed tree; a config's paths are read relative to the working
directory, as the reference reads them.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

# The stock configs, shipped as package data (copies of the checkout's
# configs/*.conf).
PACKAGED_CONFIGS = Path(__file__).resolve().parent / "configs"


@dataclasses.dataclass
class ExperimentConfig:
    model_config: Dict[str, Any]
    model_path: str = ""
    database_path: str = ""
    asv_score_path: str = ""
    eval_output: str = "eval_scores.txt"
    batch_size: int = 24
    num_epochs: int = 100
    track: str = "LA"
    debug_subset: Optional[Tuple[int, int, int]] = None  # (train, dev, eval)
    seed: int = 1234
    # every other key of the JSON, verbatim
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    KNOWN_KEYS = ("model_path", "database_path", "asv_score_path",
                  "eval_output", "batch_size", "num_epochs", "track",
                  "debug_subset", "seed")

    def __post_init__(self):
        if self.track not in ("LA", "PA", "DF"):
            raise ValueError(f"Invalid track given: {self.track}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        d = dict(d)
        kw: Dict[str, Any] = {k: d.pop(k) for k in cls.KNOWN_KEYS if k in d}
        if kw.get("debug_subset") is not None:
            kw["debug_subset"] = tuple(kw["debug_subset"])
        return cls(model_config=dict(d.pop("model_config", {})), extras=d,
                   **kw)

    def model_tag(self, config_name: str, comment: str = "") -> str:
        """Run-directory tag, the reference's format."""
        tag = (f"{self.track}_{config_name}_ep{self.num_epochs}"
               f"_bs{self.batch_size}")
        if comment:
            tag += f"_{comment}"
        return tag

    # --- dataset paths (the ASVspoof2019 layout) ---------------------------
    def protocol_path(self, split: str) -> Path:
        prefix = f"ASVspoof2019.{self.track}"
        sub = {"train": f"{prefix}.cm.train.trn.txt",
               "dev": f"{prefix}.cm.dev.trl.txt",
               "eval": f"{prefix}.cm.eval.trl.txt"}[split]
        return (Path(self.database_path)
                / f"ASVspoof2019_{self.track}_cm_protocols" / sub)

    def audio_dir(self, split: str) -> Path:
        return Path(self.database_path) / f"ASVspoof2019_{self.track}_{split}"

    def asv_scores(self) -> Path:
        return Path(self.database_path) / self.asv_score_path


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
