"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points default to CUDA."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "aasist_tpu_torch"


def _submodules():
    import aasist_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        aasist_tpu_torch.__path__, "aasist_tpu_torch."))


def test_import_pulls_in_no_jax():
    # a fresh interpreter: this one already imported jax in conftest.py
    mods = ["aasist_tpu_torch"] + _submodules()
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'aasist_tpu'))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    assert len(mods) >= 14


def test_scan_reaches_every_module():
    """Every .py file of the package is a module that the scans here import
    and read, so a new source is held to them the day it lands."""
    names = set()
    for path in PKG.rglob("*.py"):
        parts = path.relative_to(ROOT).with_suffix("").parts
        names.add(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    assert names == {"aasist_tpu_torch", *_submodules()}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = {"jax", "jaxlib", "aasist_tpu"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {bad}"


def test_scorer_defaults_to_cuda_and_raises_without_it():
    import torch

    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.serving import Scorer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model({
        "architecture": "AASIST", "first_conv": 128,
        "filts": [70, [1, 4], [4, 4], [4, 4], [4, 4]], "gat_dims": [4, 4],
        "pool_ratios": [0.5, 0.5, 0.5, 0.5],
        "temperatures": [2.0, 2.0, 100.0, 100.0]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scorer(model)
