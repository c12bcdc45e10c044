"""Batched inference serving (counterpart of ``aasist_tpu/serving.py``).

Usage::

    scorer = Scorer.from_config("configs/AASIST.conf")   # loads weights
    scores = scorer.score_waveforms([wav1, wav2, ...])   # bonafide scores
    label = "bonafide" if scores[0] > threshold else "spoof"

A batch of n rows runs at the smallest of the scorer's row buckets that
holds it (``row_buckets``: the powers of two from ``MIN_BUCKET`` up to
``batch_size``, and ``batch_size``), padded by repeating its last row; the
padding's scores are dropped.  Each utterance's score is a function of its
own row alone (BatchNorm on running statistics, graph pooling per
utterance), so the bucket changes the work, not the answer.  A full batch
runs at ``batch_size``; a scorer over a mesh of several devices runs every
batch at ``batch_size``.  ``Scorer.counters`` counts the rows asked for and
the rows run.  The forward is eager PyTorch under ``torch.inference_mode()``.

Batches are dispatched two deep (``utils/dispatch.py:pipelined``), as the
JAX Scorer does: on a card, a batch is copied into a pinned host buffer,
sent with a non-blocking copy, run, and its scores copied back into a
pinned buffer behind an event; the host reads them only when the batch
after the next has been queued.  On the CPU each batch is scored at once.

With ``mesh`` (``parallel/mesh.py:DataMesh``) the scorer is data-parallel
in one process, as the JAX Scorer's ``mesh``: a replica of the model on
each device, each batch split by rows, each part queued on its device's
stream and its scores copied into the batch's pinned buffer behind that
device's event.

Under a profiler (``utils/profiling.py:annotate``) each batch is the span
``serving.dispatch``, its sequence number in the span's arguments, with
the children ``serving.acquire`` (the wait for a free slot),
``serving.fill`` (the rows written into the slot), ``serving.send`` (the
non-blocking copy in) and ``serving.forward`` (the forward queued and the
scores' copy back); on the CPU ``serving.forward`` alone.  Reading its
scores is ``serving.drain``, with the same sequence number, and its child
``serving.wait`` (the wait for the slot's events).  The number pairs a
batch's dispatch with its drain in a trace viewer.
"""

from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from aasist_tpu_torch.data.dataset import (FIXED_EVAL_LEN, pad_into,
                                           pad_to_fixed)
from aasist_tpu_torch.ops.fused_stack import takes_block0
from aasist_tpu_torch.utils.dispatch import Slot, SlotRing, pipelined, record
from aasist_tpu_torch.utils.profiling import annotate

# Serving batch per architecture: the JAX package's starting values (128;
# RawNet2's 1-D trunk 256; SSL_AASIST, the port's own, 128), not yet
# measured on the H100.  Keys are model_config["architecture"] names;
# others get 128.
SERVING_BATCH_DEFAULTS = {
    "AASIST": 128,
    "AASIST2": 128,
    "AASIST_Robust": 128,
    "RawNet2Spoof": 256,
    "RawNetGatSpoofST": 128,
    "SSL_AASIST": 128,
}

# Batches in flight while scoring a list (``utils/dispatch.py``), as in
# ``ops/long_audio.py``: the reference's depth.
DISPATCH_DEPTH = 2

# The smallest row bucket of a one-device scorer (``row_buckets``): below
# it the forward's fixed cost of kernel launches outweighs its rows.
MIN_BUCKET = 16


def row_buckets(batch_size: int) -> Tuple[int, ...]:
    """The row counts a one-device scorer of ``batch_size`` runs a batch
    at: the powers of two from ``MIN_BUCKET`` up to ``batch_size``, and
    ``batch_size`` (128: 16, 32, 64, 128; 16 or less: ``batch_size``
    alone)."""
    buckets, rows = [], MIN_BUCKET
    while rows < batch_size:
        buckets.append(rows)
        rows *= 2
    return (*buckets, batch_size)


def _pad_rows(batch: np.ndarray, size: int) -> np.ndarray:
    n = batch.shape[0]
    if n == size:
        return batch
    return np.concatenate([batch, np.repeat(batch[-1:], size - n, axis=0)])


def kernel_route(model: torch.nn.Module, *, bf16: bool, device_type: str,
                 use_fused_frontend: Optional[bool] = None,
                 use_fused_stack: Optional[bool] = None) -> str:
    """Set ``model``'s kernel paths as a Scorer computing in bf16 (or f32)
    on a ``device_type`` device sets them, and return the route of its eval
    forward: "stack" (the frontend + block-0 kernel pair), "frontend" (the
    sinc-frontend kernel, block 0 on stock ops) or "stock" (also the
    route of a model with neither path, such as SSL_AASIST).

    ``None`` decides from the model: in bf16 on CUDA the frontend kernel
    for a model that has it, and the pair for one that has the stack path
    (``has_fused_stack``) with a block 0 the kernels take
    (``ops.fused_stack.takes_block0``).  ``True`` on a model without the
    path raises."""
    auto = bf16 and device_type == "cuda"
    if use_fused_frontend is None:
        use_fused_frontend = auto and hasattr(model, "use_fused_frontend")
    if use_fused_stack is None:
        use_fused_stack = (auto and getattr(model, "has_fused_stack", False)
                           and takes_block0(model.encoder[0]))
    for key, on, path in (
            ("use_fused_frontend", use_fused_frontend, "fused frontend"),
            ("use_fused_stack", use_fused_stack, "fused frontend + block-0")):
        if hasattr(model, key):
            setattr(model, key, bool(on))  # AASIST2's stack raises
        elif on:
            raise ValueError(f"Scorer: {type(model).__name__} has no "
                             f"{path} path")
    if getattr(model, "use_fused_stack", False):
        return "stack"
    if getattr(model, "use_fused_frontend", False):
        return "frontend"
    return "stock"


class _Ticket(NamedTuple):
    """A dispatched batch: its ``n`` real rows' scores, already computed
    (CPU), or in ``slot`` once its event has completed, while the slot
    still carries batch ``gen`` (CUDA); ``seq`` numbers the scorer's
    batches, the argument of the batch's ``serving.dispatch`` and
    ``serving.drain`` spans."""
    n: int
    scores: Optional[np.ndarray]
    slot: Optional[Slot]
    gen: int
    seq: int


class Scorer:
    """Warm batched scorer around a model with its weights loaded.

    ``device=None`` means ``"cuda"``, and raises when no card is present;
    pass ``device="cpu"`` to score on the CPU.  ``bf16=True`` casts the
    float32 weights and buffers to bfloat16 and computes in it.
    The kernels are chosen once, here (``kernel_route``).
    ``use_fused_frontend=None`` turns the CUDA sinc-frontend kernel on when
    computing in bf16 on a CUDA device, for a model that has that path
    (AASIST, AASIST2, AASIST-Robust, RawGAT-ST; not RawNet2).
    ``use_fused_stack=None`` runs the frontend and residual block 0 through
    the CUDA kernel pair of ``ops/fused_stack`` instead, in bf16 on a CUDA
    device, for a residual encoder whose block 0 the pair takes (1 -> 32
    channels with a downsample: AASIST, AASIST-L); ``use_fused_stack=False``
    keeps such a model on the frontend kernel and block 0 on stock ops.
    Asking for a path the model lacks raises.  The caller's model is not
    changed: the scorer works on its own copy.  ``mesh`` spreads each batch
    over its devices (one replica each, ``batch_size`` a multiple of the
    mesh's size); ``device`` is then the mesh's first.

    A batch of n rows runs at the smallest of ``buckets`` that holds n:
    ``row_buckets(batch_size)`` on one device, ``batch_size`` alone over a
    mesh of several.  ``counters`` holds running totals over every batch
    dispatched: ``batches``, ``rows`` (the rows asked for), ``rows_run``
    (the rows computed) and ``by_rows`` (batches by bucket); each batch
    publishes a new dict, so one read is one consistent set of totals.
    ``1 - rows / rows_run`` is the share of computed rows that were
    padding.
    """

    def __init__(self, model: torch.nn.Module, *,
                 batch_size: Optional[int] = None,
                 window: int = FIXED_EVAL_LEN, bf16: bool = True,
                 use_fused_frontend: Optional[bool] = None,
                 use_fused_stack: Optional[bool] = None, device=None,
                 mesh=None):
        devices = (list(mesh.devices) if mesh is not None
                   else [torch.device("cuda" if device is None else device)])
        device = devices[0]
        if (any(d.type == "cuda" for d in devices)
                and not torch.cuda.is_available()):
            raise RuntimeError(
                "Scorer: no CUDA device is available; pass device='cpu' to "
                "score on the CPU")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"Scorer: a mesh of one device type, not "
                             f"{devices}")
        if batch_size is None:
            arch = getattr(model, "config", {}).get("architecture")
            batch_size = SERVING_BATCH_DEFAULTS.get(arch, 128)
        if batch_size % len(devices):
            raise ValueError(f"Scorer: batch_size {batch_size} is not "
                             f"divisible by the mesh's {len(devices)} "
                             "devices")
        self.batch_size = batch_size
        self.window = window
        self.device = device

        model = copy.deepcopy(model).eval().to(device)
        if bf16:
            model = model.to(torch.bfloat16)
        kernel_route(model, bf16=bf16, device_type=device.type,
                     use_fused_frontend=use_fused_frontend,
                     use_fused_stack=use_fused_stack)
        self.model = model
        replicas = {device: model}
        for d in devices:
            if d not in replicas:
                replicas[d] = copy.deepcopy(model).to(d)
        # (device, replica) of each part of a batch, split by rows
        self._replicas = [(d, replicas[d]) for d in devices]
        # a mesh's parts split batch_size's rows, so it runs no other size
        self.buckets = (row_buckets(batch_size) if len(devices) == 1
                        else (batch_size,))
        self.counters = {"batches": 0, "rows": 0, "rows_run": 0,
                         "by_rows": dict.fromkeys(self.buckets, 0)}
        # a ring of pinned slots, one per batch in flight: DISPATCH_DEPTH
        # + 1 tickets exist at once while a list is scored, and a slot
        # comes round again only after its ticket has been drained
        self._ring = SlotRing(DISPATCH_DEPTH + 1, (batch_size, window),
                              batch_size)
        self._seq = 0       # batches dispatched

    @classmethod
    def from_config(cls, config_path, weights_path=None, **kwargs
                    ) -> "Scorer":
        from aasist_tpu_torch.cli import load_model_weights
        from aasist_tpu_torch.config import load_config
        from aasist_tpu_torch.registry import build_model

        cfg = load_config(config_path)
        model = build_model(cfg.model_config)
        load_model_weights(model, weights_path or cfg.model_path)
        return cls(model, **kwargs)

    def _count(self, n: int, rows: int) -> None:
        """Add a batch of ``n`` rows run at ``rows`` to ``counters``."""
        c = self.counters
        self.counters = {"batches": c["batches"] + 1, "rows": c["rows"] + n,
                         "rows_run": c["rows_run"] + rows,
                         "by_rows": {**c["by_rows"],
                                     rows: c["by_rows"][rows] + 1}}

    def _dispatch(self, waves: Sequence[np.ndarray]) -> _Ticket:
        """Queue the forward of n <= batch_size waveforms, each cropped or
        tile-repeated to the window (``pad_to_fixed``; rows of the window's
        length pass as they are), the batch padded by repeating the last
        up to the smallest bucket that holds n.  On a card they are written
        straight into the first rows of a pinned buffer and sent with a
        non-blocking copy, and the scores come back into a pinned buffer
        behind an event: nothing here waits for the device.  On the CPU the
        scores are computed at once."""
        n, seq = len(waves), self._seq
        self._seq += 1
        rows = next(b for b in self.buckets if b >= n)
        step = rows // len(self._replicas)
        parts = [(slice(i * step, (i + 1) * step), device, model)
                 for i, (device, model) in enumerate(self._replicas)]
        with annotate("serving.dispatch", seq):
            if self.device.type != "cuda":
                host = np.stack([pad_to_fixed(np.asarray(w, np.float32),
                                              self.window) for w in waves])
                x = torch.from_numpy(_pad_rows(host, rows))
                with annotate("serving.forward"), torch.inference_mode():
                    scores = torch.cat([
                        model(x[part].to(device))[1][:, 1].float().cpu()
                        for part, device, model in parts])
                self._count(n, rows)
                return _Ticket(n, scores.numpy()[:n], None, 0, seq)
            with annotate("serving.acquire"):
                slot = self._ring.acquire()
            with annotate("serving.fill"):
                host = slot.rows.numpy()
                for i, w in enumerate(waves):
                    pad_into(host[i], np.asarray(w, np.float32))
                host[n:rows] = host[n - 1]
            events = []
            with torch.inference_mode():
                for part, device, model in parts:
                    with torch.cuda.device(device):
                        with annotate("serving.send"):
                            x = slot.rows[part].to(device, non_blocking=True)
                        with annotate("serving.forward"):
                            _, logits = model(x)
                            slot.scores[part].copy_(logits[:, 1].float(),
                                                    non_blocking=True)
                            events.append(record(device))
            slot.events = events
            self._count(n, rows)
            return _Ticket(n, None, slot, slot.gen, seq)

    def _drain(self, ticket: _Ticket) -> np.ndarray:
        """Wait for a dispatched batch and return its n scores.  A ticket
        must be drained before DISPATCH_DEPTH + 1 more batches are
        dispatched, or its slot carries another batch and this raises."""
        with annotate("serving.drain", ticket.seq):
            if ticket.slot is None:
                return ticket.scores
            with annotate("serving.wait"):
                ticket.slot.check(ticket.gen, "Scorer")
            return ticket.slot.scores.numpy()[:ticket.n].copy()

    def _fwd(self, waves: Sequence[np.ndarray]) -> np.ndarray:
        """n <= batch_size waveforms -> (n,) bonafide scores,
        synchronously."""
        return self._drain(self._dispatch(waves))

    def warmup(self) -> None:
        """One batch at each bucket, the largest first, so that no later
        batch meets a shape the scorer has not run."""
        for rows in reversed(self.buckets):
            self._fwd(np.zeros((rows, self.window), np.float32))

    def score_batch(self, batch: np.ndarray) -> np.ndarray:
        """Score (n, window) waveforms, n <= batch_size."""
        n = batch.shape[0]
        if n == 0:
            return np.zeros((0,), np.float32)
        if batch.shape[1] != self.window:
            raise ValueError(
                f"expected window {self.window}, got {batch.shape[1]}")
        if n > self.batch_size:
            raise ValueError(f"batch of {n} exceeds batch_size "
                             f"{self.batch_size}")
        return self._fwd(np.asarray(batch, np.float32))

    def score_waveforms(self, waveforms: Sequence[np.ndarray],
                        long_audio: bool = False,
                        aggregate: str = "mean") -> List[float]:
        """Score variable-length waveforms.

        Default: the reference's eval semantics (crop or tile to the
        window).  ``long_audio=True`` scores strided windows and aggregates
        them, covering audio beyond the window.
        """
        if long_audio:
            from aasist_tpu_torch.ops.long_audio import score_long_audio
            return score_long_audio(
                waveforms, self._dispatch, self._drain, window=self.window,
                batch_size=self.batch_size, aggregate=aggregate)
        scores: List[float] = []

        def dispatch(i):
            return self._dispatch(waveforms[i:i + self.batch_size])

        pipelined(range(0, len(waveforms), self.batch_size), dispatch,
                  lambda t: scores.extend(self._drain(t).tolist()),
                  DISPATCH_DEPTH)
        return scores
