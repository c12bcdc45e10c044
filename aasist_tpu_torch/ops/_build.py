"""Build the port's CUDA sources with ``nvcc`` at first use.

Each source under ``csrc/`` compiles to a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/aasist_tpu_torch/`` at the root of the
checkout, named by a hash of the source, the headers under ``csrc/``, the
flags and the preprocessor definitions: an edited source or header is
rebuilt, an unchanged one is reused, and a variant built with other
definitions gets a library of its own.
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
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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


_loaded: Dict[Tuple[str, Tuple[str, ...]], Library] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def load(name: str, defines: Optional[Mapping[str, object]] = None
         ) -> Library:
    """Compile (if needed) and load ``csrc/<name>.cu``.  ``defines`` are
    preprocessor definitions (``{"NAME": value}``, ``None`` for a bare
    ``-DNAME``): a compile-time variant of the source."""
    dflags = tuple(f"-D{k}" if v is None else f"-D{k}={v}"
                   for k, v in sorted((defines or {}).items()))
    key = (name, dflags)
    if key in _loaded:
        return _loaded[key]
    src = CSRC / f"{name}.cu"
    flags = [*NVCC_FLAGS, *dflags]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd: List[str] = [_nvcc(), *flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} {dflags}:\n{log}")
        os.replace(tmp, out)     # atomic: concurrent builders never see half
    _loaded[key] = Library(ctypes.CDLL(str(out)), out, seconds, log)
    return _loaded[key]


def load_all(entries: Sequence[Tuple[str, Optional[Mapping[str, object]]]]
             ) -> List[Library]:
    """``load`` several ``(name, defines)`` entries, their nvcc builds all
    started together; the libraries come back in the entries' order."""
    with concurrent.futures.ThreadPoolExecutor(len(entries)) as pool:
        return list(pool.map(lambda e: load(*e), entries))
