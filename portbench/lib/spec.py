"""What ``BENCHMARK.json`` says about one cell, and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric is a file of its own, found by its name:

  <file of the configuration entry>      the configuration (sizes, weights,
                                         precision, FLOP counts)
  portbench/traffic/<traffic>.json       the traffic mix's parameters
  portbench/limits/<cell>.json           the limits of the output check
  portbench/metrics/<metric>.py          a per-layer metric's reader

so a later cell is new files and entries, and no edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HARNESS = "portbench"


class UnknownWorkload(KeyError):
    """``--workload`` names no cell of ``BENCHMARK.json``."""


@dataclasses.dataclass
class Cell:
    root: Path                  # the checkout
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, Dict[str, Any]]
    end_to_end: List[Dict[str, Any]]   # the entries this cell reports
    per_layer: List[Dict[str, Any]]

    @property
    def harness_dir(self) -> Path:
        return self.root / HARNESS

    @property
    def reference(self):
        """The configuration's plain reference,
        ``portbench/reference/<config's "reference">.py``."""
        return importlib.import_module(
            f"{HARNESS}.reference.{self.config['reference']}")


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _reported(entries, cell: str) -> List[Dict[str, Any]]:
    """The metrics of a list that ``cell`` reports: those without a
    ``workloads`` key, and those that list it."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(root: Path, name: str) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise UnknownWorkload(
            f"unknown workload {name!r}; BENCHMARK.json has "
            f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    harness = root / HARNESS
    return Cell(
        root=root, name=name, chips=int(w["chips"]),
        config_name=conf["name"], config=_read(root / conf["file"]),
        traffic_name=w["traffic"],
        traffic=_read(harness / "traffic" / f"{w['traffic']}.json"),
        limits=_read(harness / "limits" / f"{name}.json"),
        end_to_end=_reported(bench["end_to_end"], name),
        per_layer=_reported(bench["per_layer"], name))


def metric_reader(cell: Cell, name: str
                  ) -> Callable[[Any], Optional[float]]:
    """``read`` of ``portbench/metrics/<name>.py``, loaded by path (a
    metric's name may hold dots)."""
    path = cell.harness_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{HARNESS}_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
