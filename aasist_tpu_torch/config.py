"""Read the reference-format JSON ``configs/*.conf``.

Own copy of ``aasist_tpu/config.py``: the ``model_config`` block, the
optimiser's ``optim_config`` (``OptimConfig``), the DCS windowing
``dynamic_chunk`` (``DynamicChunkConfig``), the loss keys, ``model_path``,
the dataset paths and the run-directory keys.  Every other key
(``mixed_precision``, ``grad_accum_steps``, ``train_chain``,
``train_fixed_length``, ``label_smoothing``, ``eval_batch_size``,
``eval_chain``, the robust-training extras) is kept verbatim in ``extras``.
String booleans ("True" / "False") are read as the reference reads them.
The stock configs ride along as package data (``aasist_tpu_torch/configs/``),
so ``load_config("AASIST")`` works from an installed tree; a config's paths
are read relative to the working directory, as the reference reads them.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

# The stock configs, shipped as package data (copies of the checkout's
# configs/*.conf).
PACKAGED_CONFIGS = Path(__file__).resolve().parent / "configs"


def str_to_bool(val: Union[str, bool, int]) -> bool:
    """The reference's truthy-string rule: y/yes/t/true/on/1 and
    n/no/f/false/off/0, any case; bools and ints as themselves."""
    if isinstance(val, bool):
        return val
    if isinstance(val, int):
        return bool(val)
    v = str(val).lower()
    if v in ("y", "yes", "t", "true", "on", "1"):
        return True
    if v in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {val!r}")


@dataclasses.dataclass
class OptimConfig:
    """The optimiser and its schedule (the config's ``optim_config``);
    ``epochs`` and ``steps_per_epoch`` are filled in by the trainer."""

    optimizer: str = "adam"
    base_lr: float = 1e-4
    lr_min: float = 5e-6
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 1e-4
    amsgrad: bool = False
    momentum: float = 0.9
    nesterov: bool = False
    scheduler: str = "cosine"
    milestones: Tuple[int, ...] = ()
    lr_decay: float = 0.1
    T0: int = 10
    Tmult: int = 2
    keras_decay: float = 1e-4
    epochs: int = 0
    steps_per_epoch: int = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OptimConfig":
        kw: Dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                v = d[f.name]
                if f.name in ("amsgrad", "nesterov"):
                    v = str_to_bool(v)
                elif f.name in ("betas", "milestones"):
                    v = tuple(v)
                kw[f.name] = v
        return cls(**kw)


@dataclasses.dataclass
class DynamicChunkConfig:
    """Dynamic chunk size (DCS) training windows: per-row lengths drawn in
    [min_samples, max_samples], each batch padded to the smallest of
    ``num_buckets`` fixed lengths that covers its longest row."""

    enabled: bool = False
    min_samples: int = 16000
    max_samples: int = 96000
    num_buckets: int = 6

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DynamicChunkConfig":
        return cls(enabled=str_to_bool(d.get("enabled", False)),
                   min_samples=int(d.get("min_samples", 16000)),
                   max_samples=int(d.get("max_samples", 96000)),
                   num_buckets=int(d.get("num_buckets", 6)))


@dataclasses.dataclass
class ExperimentConfig:
    model_config: Dict[str, Any]
    optim_config: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    model_path: str = ""
    database_path: str = ""
    asv_score_path: str = ""
    eval_output: str = "eval_scores.txt"
    batch_size: int = 24
    num_epochs: int = 100
    track: str = "LA"
    debug_subset: Optional[Tuple[int, int, int]] = None  # (train, dev, eval)
    seed: int = 1234
    loss: str = "CCE"
    eval_all_best: bool = True
    freq_aug: bool = False
    # AM-Softmax, and ALMFT's duration-adaptive margin A * dur + B
    am_softmax_scale: float = 15.0
    adaptive_margin: bool = True
    margin_a: float = 3 / 50
    margin_b: float = 7 / 50
    margin: float = 0.2
    dynamic_chunk: DynamicChunkConfig = dataclasses.field(
        default_factory=DynamicChunkConfig)
    # every other key of the JSON, verbatim
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    KNOWN_KEYS = ("model_path", "database_path", "asv_score_path",
                  "eval_output", "batch_size", "num_epochs", "track",
                  "debug_subset", "seed", "loss", "eval_all_best",
                  "freq_aug", "am_softmax_scale", "adaptive_margin",
                  "margin_a", "margin_b", "margin")
    BOOL_KEYS = ("eval_all_best", "freq_aug", "adaptive_margin")

    def __post_init__(self):
        if self.track not in ("LA", "PA", "DF"):
            raise ValueError(f"Invalid track given: {self.track}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        d = dict(d)
        optim = OptimConfig.from_dict(d.pop("optim_config", {}))
        optim.epochs = int(d.get("num_epochs", 100))
        dcs = DynamicChunkConfig.from_dict(d.pop("dynamic_chunk", {}))
        kw: Dict[str, Any] = {k: d.pop(k) for k in cls.KNOWN_KEYS if k in d}
        for k in cls.BOOL_KEYS:
            if k in kw:
                kw[k] = str_to_bool(kw[k])
        if kw.get("debug_subset") is not None:
            kw["debug_subset"] = tuple(kw["debug_subset"])
        return cls(model_config=dict(d.pop("model_config", {})),
                   optim_config=optim, dynamic_chunk=dcs, extras=d, **kw)

    def extra_flag(self, key: str, default: bool = False) -> bool:
        """A boolean key of ``extras`` (``mixed_precision``,
        ``use_mixup``, ``adv_training``) by the truthy-string rule."""
        return str_to_bool(self.extras.get(key, default))

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
