"""AASIST-Robust forward, eval and train (counterpart of
``aasist_tpu/models/aasist_robust.py``).

AASIST's frontend (the standard geometry: kernel ``first_conv``, stride 1)
and residual encoder, AASIST's spectral and temporal graphs, then ONE
HtrgGAT branch: HtrgGAT (temperature t2) -> pool_hS (ratio r2) / pool_hT
(ratio r3) -> HtrgGAT (temperature t3) + residual; readout
[max|T|, mean T, max|S|, mean S] -> ``out_layer``.  An auxiliary head reads
the encoder output's mean over frequency and time, and the eval output
mixes the two by ``softmax(ensemble_weight)``.

The forward returns ``(ensemble, logits)``: element [1], the one the Scorer,
the eval loop and the trainer's loss read, is the main head, as in the JAX
package and the reference's call sites; in train mode the ensemble is the
main head alone.  Train mode adds Gaussian input noise of
``noise_sigma * std(x)`` (the std not differentiated) and the non-local
means denoising block on ``max|e|`` over frequency, added back to the
encoder output, with AASIST's train-mode BatchNorm, dropouts and
``freq_aug``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from aasist_tpu_torch import nn
from aasist_tpu_torch.models import layers as L
from aasist_tpu_torch.models.aasist import (SincFrontendModel, graph_views,
                                            readout)


class NonLocalDenoise(tnn.Module):
    """Non-local means denoising over (B, C, T) (the JAX package's
    ``_denoise_apply``): 1x1 convs ``g``, ``theta``, ``phi``; attention
    softmax(theta^T phi) over the time axis applied to ``g``; the 1x1 conv
    ``W`` and a BatchNorm; plus the input.  The model runs it in training
    only."""

    def __init__(self, channels: int):
        super().__init__()
        for name in ("g", "theta", "phi", "W"):
            setattr(self, name, tnn.Conv1d(channels, channels, 1))
        self.bn = tnn.BatchNorm1d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = torch.softmax(torch.einsum("bct,bcu->btu", self.theta(x),
                                         self.phi(x)), dim=-1)
        y = torch.einsum("bcu,btu->bct", self.g(x), att)
        return nn.batch_norm(self.bn, self.W(y), axis=1) + x


class AasistRobustModel(SincFrontendModel):
    """AASIST-Robust; ``use_fused_frontend`` as AASIST's."""

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
        self.noise_sigma = float(model_config.get("noise_sigma", 0.1))
        self.eval()

    def forward(self, x: torch.Tensor, *,
                rngs: Optional[nn.RngStream] = None, freq_aug: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) waveform -> (ensemble logits (B, 2), logits (B, 2))."""
        train = self.training
        x, bank = L.model_input(self, x, rngs, freq_aug)
        if train and self.noise_sigma > 0:
            g = rngs.next(x.device) if rngs is not None else None
            if g is None:
                raise ValueError("AASIST-Robust's train-mode input noise "
                                 "needs an RngStream with a key")
            scale = self.noise_sigma * x.detach().std(correction=0)
            x = x + scale * torch.randn(x.shape, generator=g,
                                        device=x.device, dtype=x.dtype)
        e = self.frontend(x, bank)
        for block in self.encoder:
            e = block(e)                                      # (B,C,F,T)
        e_flat = e.mean(dim=(2, 3))                           # aux features
        if train:
            e = e + self.denoising(e.abs().amax(dim=2))[:, :, None, :]
        out_t, out_s = graph_views(self, e, rngs)
        out_t, out_s, master = self.HtrgGAT_layer_ST1(out_t, out_s,
                                                      self.master1, rngs)
        out_s = self.pool_hS(out_s, rngs)
        out_t = self.pool_hT(out_t, rngs)
        t_aug, s_aug, _ = self.HtrgGAT_layer_ST2(out_t, out_s, master, rngs)
        out_t = nn.stream_dropout(rngs, out_t + t_aug, 0.2, train)
        out_s = nn.stream_dropout(rngs, out_s + s_aug, 0.2, train)
        out = nn.stream_dropout(rngs, torch.cat(readout(out_t, out_s), dim=1),
                                0.5, train)
        logits = self.out_layer(out)
        if train:
            return logits, logits
        aux_logits = self.aux_out_layer(e_flat)
        w = torch.softmax(self.ensemble_weight, dim=0)
        return w[0] * logits + w[1] * aux_logits, logits
