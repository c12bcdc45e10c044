"""Start the ranks of a data-parallel run on this host, as ``torchrun
--nproc_per_node N`` does: N processes of one command, each with
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` set, on a free localhost port.
``cli.main`` starts its ranks with it on a host with several cards, as do
the dry run, the tests and ``chip_smoke.py``; a user may also run
``torchrun``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, TextIO


class RanksFailed(RuntimeError):
    """A rank exited non-zero or outlived its time: ``returncode`` is the
    first failing rank's exit code (1 for a timeout), ``outputs`` every
    rank's output."""

    def __init__(self, msg: str, returncode: int, outputs: List[str]):
        super().__init__(msg)
        self.returncode = returncode
        self.outputs = outputs


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(argv: Sequence[str], nproc: int, *, timeout: Optional[float],
          env: Optional[Dict[str, str]] = None, cwd=None,
          echo: Optional[TextIO] = None) -> List[str]:
    """Run ``argv`` as ranks 0 .. nproc - 1 and return their outputs
    (stdout and stderr together).  With ``echo``, rank 0's output is also
    written there line by line as it comes.  Raises ``RanksFailed`` when a
    rank exits non-zero or outlives ``timeout`` seconds (None: no limit),
    with every rank's output; no rank is left running."""
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
    lines: List[List[str]] = [[] for _ in procs]

    def read(rank: int) -> None:
        for line in procs[rank].stdout:
            lines[rank].append(line)
            if rank == 0 and echo is not None:
                echo.write(line)
                echo.flush()

    readers = [threading.Thread(target=read, args=(r,), daemon=True)
               for r in range(nproc)]
    for t in readers:
        t.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    failed, code = [], 0
    try:
        for rank, p in enumerate(procs):
            left = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                p.wait()
                failed.append(f"rank {rank} timed out after {timeout} s")
                code = code or 1
                continue
            if p.returncode != 0:
                failed.append(f"rank {rank} exited {p.returncode}")
                code = code or p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in readers:
            t.join()
        for p in procs:
            p.stdout.close()
    outs = ["".join(ln) for ln in lines]
    if failed:
        raise RanksFailed(
            f"{' ; '.join(failed)} running {' '.join(argv)}:\n"
            + "\n".join(f"--- rank {r} ---\n{o[-4000:]}"
                        for r, o in enumerate(outs)), code, outs)
    return outs
