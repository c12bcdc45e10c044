"""Data parallelism over devices and ranks (counterpart of
``aasist_tpu/parallel/mesh.py``).

The JAX package runs one program over a mesh of devices and lets XLA
insert the collectives.  The port has the two halves torch has:

  * ``DataMesh``: the devices of one process.  A batch is split by rows,
    each part runs on its own device and the parts are concatenated, with
    no collective (the mesh Scorer, ``ops/fused_frontend.py:
    fused_frontend_sharded``).  An entry may repeat, so that a one-card
    machine or the CPU can run the split.
  * ``Ranks``: this process's place in a ``torch.distributed`` process
    group, one rank per device, as ``torchrun`` starts them
    (``initialize_multihost``, ``from_env``).  A rank holds only its rows
    of every global batch (``local_rows``); the train step, BatchNorm,
    the losses and the random draws reduce over the ranks so that a step
    computes what one process computes on the whole batch.

Collectives go through ``all_reduce`` and ``broadcast`` only, the two that
Gloo also runs on CUDA tensors (ranks that share a card), so one code path
serves NCCL, Gloo on cards and Gloo on the CPU.  A gather is an
all-reduce of a zero buffer that each rank fills at its own rows: adding
zeros is exact.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import warnings
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

# a lost rank fails a collective after this long instead of hanging
DEFAULT_TIMEOUT_S = 60.0


class DataMesh:
    """The devices a single process splits its batches over: ``size``
    parts, part i on ``devices[i]``."""

    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("DataMesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def parts(self, n: int) -> List[slice]:
        """The row slices of an n-row batch, one a device; n must divide."""
        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.size} devices")
        m = n // self.size
        return [slice(i * m, (i + 1) * m) for i in range(self.size)]

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]})"


def make_mesh(n_data: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DataMesh:
    """A mesh over the first ``n_data`` of ``devices`` (default: every
    CUDA device; raises without one).  Warns when devices are left idle,
    as the JAX package's ``make_mesh`` does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass devices=['cpu', 'cpu'] to split on the "
                               "CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n_data = len(devices) if n_data is None else int(n_data)
    if not 0 < n_data <= len(devices):
        raise ValueError(f"make_mesh(n_data={n_data}) over {len(devices)} "
                         "devices")
    if n_data < len(devices):
        warnings.warn(
            f"make_mesh(n_data={n_data}) uses only {n_data} of "
            f"{len(devices)} available devices; the remaining "
            f"{len(devices) - n_data} are idle", stacklevel=2)
    return DataMesh(devices[:n_data])


def pad_batch_to_multiple(x: np.ndarray, multiple: int):
    """Pad dim 0 by repeating the last row so that it divides ``multiple``;
    returns (padded, n_real)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = np.repeat(x[-1:], rem, axis=0)
    return np.concatenate([x, pad], axis=0), n


def local_rows(n: int, rank: int, world: int, groups: int = 1) -> np.ndarray:
    """The rows of an n-row global batch that ``rank`` of ``world`` holds.
    The batch is ``groups`` consecutive microbatches (gradient
    accumulation); the rank holds its contiguous share of each, in order,
    so that its i-th local microbatch is its share of the global i-th."""
    if n % (groups * world):
        raise ValueError(f"a batch of {n} rows does not split into {groups} "
                         f"microbatches over {world} ranks")
    m = n // groups
    share = m // world
    return np.concatenate([np.arange(g * m + rank * share,
                                     g * m + (rank + 1) * share)
                           for g in range(groups)])


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks'
    gradients."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad)


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's rank in the default process group, the group's size
    and the device its tensors live on.  ``distributed`` is False for a
    process on its own (``Ranks.single``), whose collectives are the
    identity; a group of one still runs them (NCCL at world size 1)."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    distributed: bool = False

    @classmethod
    def single(cls, device="cpu") -> "Ranks":
        return cls(0, 1, torch.device(device), False)

    @property
    def main(self) -> bool:
        """Rank 0 writes the files, logs and reports."""
        return self.rank == 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t``, differentiable: the gradient
        that reaches each rank is the sum of the ranks' gradients."""
        if not self.distributed:
            return t
        return _AllReduce.apply(t)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """In place, no gradient: ``t`` becomes the sum over the ranks."""
        if self.distributed:
            torch.distributed.all_reduce(t)
        return t

    def sum_grads(self, params) -> None:
        """Sum every gradient that is not None over the ranks, in one
        flat all-reduce, in ``params``' order (the same on every rank)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not (self.distributed and grads):
            return
        flat = self.sum_(torch.cat([g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in
        rank order, no gradient."""
        if not self.distributed:
            return t
        shape = list(t.shape)
        n = shape[dim]
        shape[dim] = n * self.world
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
        out.narrow(dim, self.rank * n, n).copy_(t)
        torch.distributed.all_reduce(out)
        return out

    def broadcast(self, values: Sequence[float]) -> List[float]:
        """Rank 0's ``values`` on every rank (float64)."""
        if not self.distributed:
            return [float(v) for v in values]
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.device)
        torch.distributed.broadcast(t, 0)
        return t.cpu().tolist()

    def broadcast_tensors(self, tensors) -> None:
        """Overwrite every tensor with rank 0's, in place."""
        if self.distributed:
            with torch.no_grad():
                for t in tensors:
                    torch.distributed.broadcast(t.data, 0)

    def barrier(self) -> None:
        self.broadcast([0.0])


class RowShard(NamedTuple):
    """A rank's rows [start, stop) of a global (micro)batch of ``total``
    rows: draws over the batch take the global shape and keep these rows,
    statistics over it sum over ``ranks``."""
    start: int
    stop: int
    total: int
    ranks: Ranks


def row_shard(ranks: Ranks, local: int) -> Optional[RowShard]:
    """The shard of a rank holding ``local`` rows of each global
    (micro)batch (equal shares), or None for a single process."""
    if not ranks.distributed:
        return None
    return RowShard(ranks.rank * local, (ranks.rank + 1) * local,
                    local * ranks.world, ranks)


def sync_batch_norm(model: torch.nn.Module, ranks: Optional[Ranks]) -> None:
    """Make every BatchNorm of ``model`` take its train-mode statistics
    over all ranks' rows (``nn.batch_norm``), or with None over this
    process's rows only."""
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.dp_ranks = ranks if ranks is not None and ranks.distributed \
                else None


# where each rank puts its card's UUID in the rendezvous store
CARD_KEY = "aasist_tpu_torch/card"


def choose_backend(cards: Sequence[Optional[str]]) -> str:
    """The process group's backend from each rank's card, in rank order:
    the card's UUID, or None for a rank on the CPU.  NCCL when every rank
    holds a card of its own (distinct UUIDs: two ranks on two hosts never
    share one), else Gloo: ranks on the CPU, or two ranks sharing a card,
    which NCCL refuses."""
    if not cards or any(c is None for c in cards) \
            or len(set(cards)) < len(cards):
        return "gloo"
    return "nccl"


def card_uuid(device: torch.device) -> Optional[str]:
    """The physical card behind ``device`` (its UUID), None on the CPU.
    The UUID tells two ranks that see their card under different indices
    (``CUDA_VISIBLE_DEVICES`` per rank) apart from two that share one."""
    if device.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(device).uuid)


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, *, device=None,
                         backend: Optional[str] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> Ranks:
    """Join a process group of ``num_processes`` at ``host:port`` and return
    this process's ``Ranks``.  ``device`` is the rank's device (default:
    ``cuda:process_id`` modulo the cards, or the CPU without one).  Without
    ``backend``, each rank puts its card's UUID into the rendezvous store
    and ``choose_backend`` decides on the gathered list: NCCL when every
    rank has a physical card of its own, else Gloo.  Every collective fails
    after ``timeout_s`` seconds rather than hang on a lost rank."""
    import torch.distributed as dist

    if device is None:
        device = (f"cuda:{process_id % torch.cuda.device_count()}"
                  if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {process_id}: no CUDA device is "
                               "available; pass device='cpu'")
        if device.index is None:
            device = torch.device("cuda", process_id
                                  % torch.cuda.device_count())
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    # torch's own rendezvous: under torchrun its agent already serves the
    # store at this address, and every rank joins that one as a client
    store, _, _ = next(dist.rendezvous(
        f"tcp://{coordinator_address}?rank={process_id}"
        f"&world_size={num_processes}", timeout=timeout))
    if backend is None:
        store.set(f"{CARD_KEY}/{process_id}", card_uuid(device) or "")
        cards = [store.get(f"{CARD_KEY}/{r}").decode() or None
                 for r in range(num_processes)]
        backend = choose_backend(cards)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, store=dist.PrefixStore("default_pg", store),
        world_size=num_processes, rank=process_id, timeout=timeout, **kwargs)
    return Ranks(process_id, num_processes, device, True)


def from_env(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> Ranks:
    """This process's ``Ranks`` under ``torchrun`` (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): with
    ``WORLD_SIZE`` above 1 it joins the group, on ``cuda:LOCAL_RANK`` (the
    cards taken in turn when there are fewer than ranks) or on the CPU
    with ``device="cpu"``; otherwise it is a single process on ``device``.
    Warns when more cards are visible than this host's ranks use."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = torch.device(device)
    if world <= 1:
        return Ranks.single(device)
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device is available; "
                               "pass --device cpu to run on the CPU")
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", local % n_cards)
        if local == 0 and n_cards > local_world:
            warnings.warn(
                f"{local_world} ranks on this host use {local_world} of "
                f"{n_cards} visible cards; the remaining "
                f"{n_cards - local_world} are idle", stacklevel=2)
    address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
               f"{os.environ['MASTER_PORT']}")
    return initialize_multihost(address, world, rank, device=device,
                                timeout_s=timeout_s)


def shutdown(ranks: Ranks) -> None:
    """Leave the process group, if this process joined one."""
    if ranks.distributed and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
