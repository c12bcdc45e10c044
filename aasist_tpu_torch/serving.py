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
from aasist_tpu_torch.utils.dispatch import Slot, SlotRing, pipelined, record

# Serving batch per architecture: the JAX package's starting values (128;
# RawNet2's 1-D trunk 256), not yet measured on the H100.  Keys are
# model_config["architecture"] names; others get 128.
SERVING_BATCH_DEFAULTS = {
    "AASIST": 128,
    "AASIST2": 128,
    "AASIST_Robust": 128,
    "RawNet2Spoof": 256,
    "RawNetGatSpoofST": 128,
}

# Batches in flight while scoring a list (``utils/dispatch.py``), as in
# ``ops/long_audio.py``: the reference's depth.
DISPATCH_DEPTH = 2


def _pad_rows(batch: np.ndarray, size: int) -> np.ndarray:
    n = batch.shape[0]
    if n == size:
        return batch
    return np.concatenate([batch, np.repeat(batch[-1:], size - n, axis=0)])


class _Ticket(NamedTuple):
    """A dispatched batch: its ``n`` real rows' scores, already computed
    (CPU), or in ``slot`` once its event has completed, while the slot
    still carries batch ``gen`` (CUDA)."""
    n: int
    scores: Optional[np.ndarray]
    slot: Optional[Slot]
    gen: int


class Scorer:
    """Warm batched scorer around a model with its weights loaded.

    ``device=None`` means ``"cuda"``, and raises when no card is present;
    pass ``device="cpu"`` to score on the CPU.  ``bf16=True`` casts the
    float32 weights and buffers to bfloat16 and computes in it.
    ``use_fused_frontend=None`` turns the CUDA sinc-frontend kernel on when
    computing in bf16 on a CUDA device, for a model that has that path
    (AASIST, AASIST2, AASIST-Robust, RawGAT-ST; not RawNet2).
    ``use_fused_stack=True`` runs the frontend and residual block 0 through
    the CUDA kernel pair of ``ops/fused_stack`` instead (off by default;
    AASIST's residual encoder only).  Asking for a path the model lacks
    raises.  The caller's model is not changed: the scorer works on its own
    copy.
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
            use_fused_frontend = (bf16 and device.type == "cuda"
                                  and hasattr(model, "use_fused_frontend"))
        for key, on, path in (
                ("use_fused_frontend", use_fused_frontend, "fused frontend"),
                ("use_fused_stack", use_fused_stack,
                 "fused frontend + block-0")):
            if hasattr(model, key):
                setattr(model, key, bool(on))  # AASIST2's stack raises
            elif on:
                raise ValueError(f"Scorer: {type(model).__name__} has no "
                                 f"{path} path")
        self.model = model
        # a ring of pinned slots, one per batch in flight: DISPATCH_DEPTH
        # + 1 tickets exist at once while a list is scored, and a slot
        # comes round again only after its ticket has been drained
        self._ring = SlotRing(DISPATCH_DEPTH + 1, (batch_size, window),
                              batch_size)

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
        slot = self._ring.acquire()
        host = slot.rows.numpy()
        for i, w in enumerate(waves):
            pad_into(host[i], np.asarray(w, np.float32))
        host[n:] = host[n - 1]
        with torch.inference_mode(), torch.cuda.device(self.device):
            x = slot.rows.to(self.device, non_blocking=True)
            _, logits = self.model(x)
            slot.scores.copy_(logits[:, 1].float(), non_blocking=True)
            slot.event = record(self.device)
        return _Ticket(n, None, slot, slot.gen)

    def _drain(self, ticket: _Ticket) -> np.ndarray:
        """Wait for a dispatched batch and return its n scores.  A ticket
        must be drained before DISPATCH_DEPTH + 1 more batches are
        dispatched, or its slot carries another batch and this raises."""
        if ticket.slot is None:
            return ticket.scores
        ticket.slot.check(ticket.gen, "Scorer")
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
