"""Build the port's CUDA sources with ``nvcc`` at first use.

Each source under ``csrc/`` compiles to a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/aasist_tpu_torch/`` at the root of the
checkout, named by a hash of the source and the flags: an edited source is
rebuilt, an unchanged one is reused.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aasist_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclasses.dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an earlier build was reused
    log: str                 # nvcc's output (ptxas registers / spills)


_loaded: Dict[str, Library] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def load(name: str) -> Library:
    """Compile (if needed) and load ``csrc/<name>.cu``."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd: List[str] = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        os.replace(tmp, out)     # atomic: concurrent builders never see half
    _loaded[name] = Library(ctypes.CDLL(str(out)), out, seconds, log)
    return _loaded[name]


def load_all(names: Sequence[str]) -> Dict[str, Library]:
    """``load`` several sources, their nvcc builds all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))
