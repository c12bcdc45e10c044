"""Batched inference serving (counterpart of ``aasist_tpu/serving.py``).

Usage::

    scorer = Scorer.from_config("configs/AASIST.conf")   # loads weights
    scores = scorer.score_waveforms([wav1, wav2, ...])   # bonafide scores
    label = "bonafide" if scores[0] > threshold else "spoof"

Every batch has the scorer's fixed size: ragged requests are padded by
repeating their last row and the padding's scores are dropped.  The forward
is eager PyTorch under ``torch.inference_mode()``.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from aasist_tpu_torch.data.dataset import FIXED_EVAL_LEN, pad_to_fixed

# Serving batch per architecture.  128 is a starting value, not yet
# measured on the H100; keys are model_config["architecture"] names.
SERVING_BATCH_DEFAULTS = {"AASIST": 128}


def _pad_rows(batch: np.ndarray, size: int) -> np.ndarray:
    n = batch.shape[0]
    if n == size:
        return batch
    return np.concatenate([batch, np.repeat(batch[-1:], size - n, axis=0)])


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

    def _fwd(self, rows: np.ndarray) -> np.ndarray:
        """(batch_size, window) float32 -> (batch_size,) bonafide scores."""
        with torch.inference_mode():
            x = torch.from_numpy(rows).to(self.device)
            _, logits = self.model(x)
            return logits[:, 1].float().cpu().numpy()

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
        rows = _pad_rows(np.asarray(batch, np.float32), self.batch_size)
        return self._fwd(rows)[:n]

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
                waveforms, self._fwd, window=self.window,
                batch_size=self.batch_size, aggregate=aggregate)
        scores: List[float] = []
        for i in range(0, len(waveforms), self.batch_size):
            rows = np.stack([pad_to_fixed(np.asarray(w), self.window)
                             for w in waveforms[i:i + self.batch_size]])
            n = rows.shape[0]
            out = self._fwd(_pad_rows(rows.astype(np.float32),
                                      self.batch_size))
            scores.extend(out[:n].tolist())
        return scores
