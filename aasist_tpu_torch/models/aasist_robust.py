"""AASIST-Robust eval forward (counterpart of
``aasist_tpu/models/aasist_robust.py``).

AASIST's frontend (the standard geometry: kernel ``first_conv``, stride 1)
and residual encoder, AASIST's spectral and temporal graphs, then ONE
HtrgGAT branch: HtrgGAT (temperature t2) -> pool_hS (ratio r2) / pool_hT
(ratio r3) -> HtrgGAT (temperature t3) + residual; readout
[max|T|, mean T, max|S|, mean S] -> ``out_layer``.  An auxiliary head reads
the encoder output's mean over frequency and time, and the eval output
mixes the two by ``softmax(ensemble_weight)``.

The forward returns ``(ensemble, logits)``: element [1], the one the Scorer
and the eval loop score, is the main head, as in the JAX package and the
reference's call sites.  The train-time input noise and the non-local
denoising block wait for the training slice; the block's parameters exist
so that checkpoints load strictly.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn as tnn

from aasist_tpu_torch.models import layers as L
from aasist_tpu_torch.models.aasist import (SincFrontendModel, graph_views,
                                            readout)


class NonLocalDenoise(tnn.Module):
    """The parameters of the non-local means denoising block over
    (B, C, T): 1x1 convs ``g``, ``theta``, ``phi``, ``W`` and a BatchNorm.
    It runs only in training (the JAX package's ``_denoise_apply``), which
    is not ported yet, so it has no forward."""

    def __init__(self, channels: int):
        super().__init__()
        for name in ("g", "theta", "phi", "W"):
            setattr(self, name, tnn.Conv1d(channels, channels, 1))
        self.bn = tnn.BatchNorm1d(channels)


class AasistRobustModel(SincFrontendModel):
    """Eval-only AASIST-Robust; ``use_fused_frontend`` as AASIST's."""

    def __init__(self, model_config: Dict[str, Any]):
        super().__init__(model_config)
        if model_config.get("use_fused_stack"):
            raise ValueError("use_fused_stack: AASIST-Robust has no fused "
                             "frontend + block-0 path")
        filts = model_config["filts"]
        g0, g1 = model_config["gat_dims"]
        self.pool_ratios = r = model_config["pool_ratios"]
        self.temperatures = t = model_config["temperatures"]
        d_enc = filts[-1][-1]
        self.encoder = L.residual_encoder(filts)
        self.denoising = NonLocalDenoise(d_enc)
        self.pos_S = tnn.Parameter(torch.randn(1, filts[0] // 3, d_enc))
        self.master1 = tnn.Parameter(torch.randn(1, 1, g0))
        # in the reference's tree, unused by the single branch
        self.master2 = tnn.Parameter(torch.randn(1, 1, g0))
        self.GAT_layer_S = L.GraphAttention(d_enc, g0, t[0])
        self.GAT_layer_T = L.GraphAttention(d_enc, g0, t[1])
        self.HtrgGAT_layer_ST1 = L.HtrgGraphAttention(g0, g1, t[2])
        self.HtrgGAT_layer_ST2 = L.HtrgGraphAttention(g1, g1, t[3])
        self.pool_S = L.GraphPool(g0, r[0])
        self.pool_T = L.GraphPool(g0, r[1])
        self.pool_hS = L.GraphPool(g1, r[2])
        self.pool_hT = L.GraphPool(g1, r[3])
        self.out_layer = tnn.Linear(4 * g1, 2)
        self.aux_out_layer = tnn.Linear(d_enc, 2)
        self.ensemble_weight = tnn.Parameter(torch.tensor([0.8, 0.2]))
        self.eval()          # only the eval forward exists in this port

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) waveform -> (ensemble logits (B, 2), logits (B, 2))."""
        e = self.frontend(L.eval_input(self, x))
        for block in self.encoder:
            e = block(e)                                      # (B,C,F,T)
        out_t, out_s = graph_views(self, e)
        out_t, out_s, master = self.HtrgGAT_layer_ST1(out_t, out_s,
                                                      self.master1)
        out_s = self.pool_hS(out_s)
        out_t = self.pool_hT(out_t)
        t_aug, s_aug, _ = self.HtrgGAT_layer_ST2(out_t, out_s, master)
        logits = self.out_layer(torch.cat(
            readout(out_t + t_aug, out_s + s_aug), dim=1))
        aux_logits = self.aux_out_layer(e.mean(dim=(2, 3)))
        w = torch.softmax(self.ensemble_weight, dim=0)
        return w[0] * logits + w[1] * aux_logits, logits
