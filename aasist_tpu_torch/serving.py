"""Batched inference serving (counterpart of ``aasist_tpu/serving.py``).

Usage::

    scorer = Scorer.from_config("configs/AASIST.conf")   # loads weights
    scores = scorer.score_waveforms([wav1, wav2, ...])   # bonafide scores
    label = "bonafide" if scores[0] > threshold else "spoof"

Every batch has the scorer's fixed size: ragged requests are padded by
repeating their last row and the padding's scores are dropped.  The forward
is eager PyTorch under ``torch.inference_mode()``.

Batches are dispatched two deep (``utils/dispatch.py:pipelined``), as the
JAX Scorer does: on a card, a batch is copied into a pinned host buffer,
sent with a non-blocking copy, run, and its scores copied back into a
pinned buffer behind an event; the host reads them only when the batch
after the next has been queued.  On the CPU each batch is scored at once.
"""

from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aasist_tpu_torch.data.dataset import (FIXED_EVAL_LEN, pad_into,
                                           pad_to_fixed)
from aasist_tpu_torch.utils.dispatch import pipelined

# Serving batch per architecture.  128 is a starting value, not yet
# measured on the H100; keys are model_config["architecture"] names.
SERVING_BATCH_DEFAULTS = {"AASIST": 128}

# Batches in flight while scoring a list (``utils/dispatch.py``), as in
# ``ops/long_audio.py``: the reference's depth.
DISPATCH_DEPTH = 2


def _pad_rows(batch: np.ndarray, size: int) -> np.ndarray:
    n = batch.shape[0]
    if n == size:
        return batch
    return np.concatenate([batch, np.repeat(batch[-1:], size - n, axis=0)])


def _record(device: torch.device) -> torch.cuda.Event:
    """An event recorded on ``device``'s current stream, where a batch's
    copies and forward were queued, whichever device is current."""
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class _Slot:
    """Pinned host buffers of one batch in flight, its rows and its scores;
    ``event`` marks the end of the last batch's work on the device and
    ``gen`` counts the batches the slot has carried."""

    def __init__(self, batch_size: int, window: int):
        self.rows = torch.empty((batch_size, window), pin_memory=True)
        self.scores = torch.empty((batch_size,), pin_memory=True)
        self.event: Optional[torch.cuda.Event] = None
        self.gen = 0


class _Ticket(NamedTuple):
    """A dispatched batch: its ``n`` real rows' scores, already computed
    (CPU), or in ``slot`` once its event has completed, while the slot
    still carries batch ``gen`` (CUDA)."""
    n: int
    scores: Optional[np.ndarray]
    slot: Optional[_Slot]
    gen: int


class Scorer:
    """Warm batched scorer around a model with its weights loaded.

    ``device=None`` means ``"cuda"``, and raises when no card is present;
    pass ``device="cpu"`` to score on the CPU.  ``bf16=True`` casts the
    float32 weights and buffers to bfloat16 and computes in it.
    ``use_fused_frontend=None`` turns the CUDA sinc-frontend kernel on when
    computing in bf16 on a CUDA device.  ``use_fused_stack=True`` runs the
    frontend and residual block 0 through the CUDA kernel pair of
    ``ops/fused_stack`` instead (off by default).  The caller's model is not
    changed: the scorer works on its own copy.
    """

    def __init__(self, model: torch.nn.Module, *,
                 batch_size: Optional[int] = None,
                 window: int = FIXED_EVAL_LEN, bf16: bool = True,
                 use_fused_frontend: Optional[bool] = None,
                 use_fused_stack: bool = False, device=None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Scorer: no CUDA device is available; pass device='cpu' to "
                "score on the CPU")
        if batch_size is None:
            arch = getattr(model, "config", {}).get("architecture")
            batch_size = SERVING_BATCH_DEFAULTS.get(arch, 128)
        self.batch_size = batch_size
        self.window = window
        self.device = device

        model = copy.deepcopy(model).eval().to(device)
        if bf16:
            model = model.to(torch.bfloat16)
        if use_fused_frontend is None:
            use_fused_frontend = bf16 and device.type == "cuda"
        if hasattr(model, "use_fused_frontend"):
            model.use_fused_frontend = bool(use_fused_frontend)
        if hasattr(model, "use_fused_stack"):
            model.use_fused_stack = bool(use_fused_stack)
        elif use_fused_stack:
            raise ValueError(f"Scorer: {type(model).__name__} has no fused "
                             "frontend + block-0 path")
        self.model = model
        # a ring of pinned slots, one per batch in flight: DISPATCH_DEPTH
        # + 1 tickets exist at once while a list is scored, and a slot
        # comes round again only after its ticket has been drained; made at
        # first use
        self._ring: List[_Slot] = []
        self._next = 0

    @classmethod
    def from_config(cls, config_path, weights_path=None, **kwargs
                    ) -> "Scorer":
        from aasist_tpu_torch.config import load_config
        from aasist_tpu_torch.registry import build_model
        from aasist_tpu_torch.weights import load_npz

        cfg = load_config(config_path)
        model = build_model(cfg.model_config)
        load_npz(model, weights_path or cfg.model_path)
        return cls(model, **kwargs)

    def _dispatch(self, waves: Sequence[np.ndarray]) -> _Ticket:
        """Queue the forward of n <= batch_size waveforms, each cropped or
        tile-repeated to the window (``pad_to_fixed``; rows of the window's
        length pass as they are), the batch padded by repeating the last.
        On a card they are written straight into a pinned buffer and sent
        with a non-blocking copy, and the scores come back into a pinned
        buffer behind an event: nothing here waits for the device.  On the
        CPU the scores are computed at once."""
        n = len(waves)
        if self.device.type != "cuda":
            rows = np.stack([pad_to_fixed(np.asarray(w, np.float32),
                                          self.window) for w in waves])
            with torch.inference_mode():
                x = torch.from_numpy(_pad_rows(rows, self.batch_size))
                _, logits = self.model(x.to(self.device))
                return _Ticket(n, logits[:, 1].float().numpy()[:n], None, 0)
        if not self._ring:
            self._ring = [_Slot(self.batch_size, self.window)
                          for _ in range(DISPATCH_DEPTH + 1)]
        slot = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        if slot.event is not None:       # its last batch is off the buffers
            slot.event.synchronize()
        slot.gen += 1
        host = slot.rows.numpy()
        for i, w in enumerate(waves):
            pad_into(host[i], np.asarray(w, np.float32))
        host[n:] = host[n - 1]
        with torch.inference_mode(), torch.cuda.device(self.device):
            x = slot.rows.to(self.device, non_blocking=True)
            _, logits = self.model(x)
            slot.scores.copy_(logits[:, 1].float(), non_blocking=True)
            slot.event = _record(self.device)
        return _Ticket(n, None, slot, slot.gen)

    def _drain(self, ticket: _Ticket) -> np.ndarray:
        """Wait for a dispatched batch and return its n scores.  A ticket
        must be drained before DISPATCH_DEPTH + 1 more batches are
        dispatched, or its slot carries another batch and this raises."""
        if ticket.slot is None:
            return ticket.scores
        if ticket.slot.gen != ticket.gen:
            raise RuntimeError(
                f"Scorer: a batch was drained after {DISPATCH_DEPTH + 1} "
                "later ones were dispatched; its buffers were reused")
        ticket.slot.event.synchronize()
        return ticket.slot.scores.numpy()[:ticket.n].copy()

    def _fwd(self, waves: Sequence[np.ndarray]) -> np.ndarray:
        """n <= batch_size waveforms -> (n,) bonafide scores,
        synchronously."""
        return self._drain(self._dispatch(waves))

    def warmup(self) -> None:
        self._fwd(np.zeros((self.batch_size, self.window), np.float32))

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
