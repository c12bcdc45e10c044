"""Start the ranks of a data-parallel run on this host, as ``torchrun
--nproc_per_node N`` does: N processes of one command, each with
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` set, on a free localhost port.  The
dry run, the tests and ``chip_smoke.py`` start their ranks with it; a user
runs ``torchrun``.
"""

from __future__ import annotations

import os
import socket
import subprocess
from typing import Dict, List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(argv: Sequence[str], nproc: int, *, timeout: float,
          env: Optional[Dict[str, str]] = None, cwd=None) -> List[str]:
    """Run ``argv`` as ranks 0 .. nproc - 1 and return their outputs
    (stdout and stderr together).  Raises when a rank exits non-zero or
    outlives ``timeout`` seconds, with every rank's output; no rank is left
    running."""
    port = free_port()
    procs = []
    for rank in range(nproc):
        e = dict(os.environ if env is None else env)
        e.update(WORLD_SIZE=str(nproc), RANK=str(rank), LOCAL_RANK=str(rank),
                 LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="localhost",
                 MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            list(argv), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=e, cwd=cwd))
    outs = [""] * nproc
    failed = []
    try:
        for rank, p in enumerate(procs):
            try:
                outs[rank], _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs[rank], _ = p.communicate()
                failed.append(f"rank {rank} timed out after {timeout} s")
                continue
            if p.returncode != 0:
                failed.append(f"rank {rank} exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise RuntimeError(
            f"{' ; '.join(failed)} running {' '.join(argv)}:\n"
            + "\n".join(f"--- rank {r} ---\n{o[-4000:]}"
                        for r, o in enumerate(outs)))
    return outs
