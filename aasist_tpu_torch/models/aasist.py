"""AASIST / AASIST-L eval forward (counterpart of
``aasist_tpu/models/aasist.py``, residual encoder only).

Dataflow for AASIST.conf at (B, 64600):
  sinc conv (70 x 129) -> |.| -> maxpool (3,3) -> first_bn -> selu
                                                   -> (B, 1, 23, 21490)
  6 residual blocks                                -> (B, 64, 23, 29)
  spectral view: max|e| over time, + pos_S -> GAT -> pool
  temporal view: max|e| over freq          -> GAT -> pool
  2 x (HtrgGAT -> pool -> HtrgGAT + residual) branches with master nodes,
  fused by elementwise max; readout [max|T|, mean T, max|S|, mean S,
  master] -> (B, 5 * gat_dims[1]) -> Linear -> 2 logits.

The model computes in the dtype it was cast to (``model.to(torch.bfloat16)``
casts the filterbank buffer with the weights).  Parameter names are the
JAX tree's paths (``encoder.0.conv1.weight``, ``first_bn.running_mean``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn as tnn

from aasist_tpu_torch import nn
from aasist_tpu_torch.models import layers as L
from aasist_tpu_torch.ops.fused_frontend import fused_frontend
from aasist_tpu_torch.ops.fused_stack import fused_frontend_block0


class AasistModel(tnn.Module):
    """Eval-only AASIST with the original residual encoder.

    ``use_fused_frontend`` routes the frontend through the CUDA kernel
    (``ops/fused_frontend``).  ``use_fused_stack`` (eval only, default off;
    the key ``tools/fused_stack.py`` names) runs the frontend and residual
    block 0 as the CUDA kernel pair of ``ops/fused_stack`` instead, and
    takes precedence.  ``b0_chunks`` is accepted and ignored: it split
    block 0 over the batch to fit TPU HBM, and the math is the same
    unchunked.
    """

    def __init__(self, model_config: Dict[str, Any]):
        super().__init__()
        # the JAX model picks the Res2Net encoder (AASIST2) by the presence
        # of res2net_* keys; that encoder is not ported yet
        encoder = model_config.get("encoder", "res2net" if (
            "res2net_width" in model_config
            or "res2net_scale" in model_config) else "residual")
        if encoder != "residual" or model_config.get("speaker_conditioning"):
            raise NotImplementedError(
                "the Res2Net encoder and speaker conditioning (AASIST2) are "
                "not ported yet; see ROADMAP.md")
        self.config = dict(model_config)
        filts = model_config["filts"]
        g0, g1 = model_config["gat_dims"]
        r = model_config["pool_ratios"]
        t = model_config["temperatures"]
        d_enc = filts[-1][-1]
        self.use_fused_frontend = bool(
            model_config.get("use_fused_frontend", False))
        self.use_fused_stack = bool(
            model_config.get("use_fused_stack", False))

        self.register_buffer("filterbank", torch.from_numpy(
            L.sinc_filterbank(filts[0], model_config["first_conv"])),
            persistent=False)
        self.first_bn = tnn.BatchNorm2d(1)
        blocks = [filts[1], filts[2], filts[3], filts[4], filts[4], filts[4]]
        self.encoder = tnn.ModuleList(
            L.ResidualBlock(cin, cout, first=(i == 0))
            for i, (cin, cout) in enumerate(blocks))

        # one spectral node per pooled filter row (23 at filts[0] = 70)
        self.pos_S = tnn.Parameter(torch.randn(1, filts[0] // 3, d_enc))
        self.master1 = tnn.Parameter(torch.randn(1, 1, g0))
        self.master2 = tnn.Parameter(torch.randn(1, 1, g0))
        self.GAT_layer_S = L.GraphAttention(d_enc, g0, t[0])
        self.GAT_layer_T = L.GraphAttention(d_enc, g0, t[1])
        self.HtrgGAT_layer_ST11 = L.HtrgGraphAttention(g0, g1, t[2])
        self.HtrgGAT_layer_ST12 = L.HtrgGraphAttention(g1, g1, t[2])
        self.HtrgGAT_layer_ST21 = L.HtrgGraphAttention(g0, g1, t[2])
        self.HtrgGAT_layer_ST22 = L.HtrgGraphAttention(g1, g1, t[2])
        self.pool_S = L.GraphPool(g0, r[0])
        self.pool_T = L.GraphPool(g0, r[1])
        self.pool_hS1 = L.GraphPool(g1, r[2])
        self.pool_hT1 = L.GraphPool(g1, r[2])
        self.pool_hS2 = L.GraphPool(g1, r[2])
        self.pool_hT2 = L.GraphPool(g1, r[2])
        self.out_layer = tnn.Linear(5 * g1, 2)
        self.eval()          # only the eval forward exists in this port

    def frontend(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) waveform -> (B, 1, C // 3, (L - 128) // 3)."""
        bank = self.filterbank
        if self.use_fused_frontend:
            bn = self.first_bn
            return fused_frontend(
                x, bank, {"weight": bn.weight, "bias": bn.bias},
                {"mean": bn.running_mean, "var": bn.running_var})
        h = L.sinc_frontend(bank, x).abs()[:, None]          # (B,1,C,L')
        h = nn.batch_norm(self.first_bn, nn.max_pool(h, (3, 3)), axis=1)
        return nn.selu(h)

    def fused_stack(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) waveform -> block 0's (B, C, C_bank // 3, (L - 128) // 9)
        through the frontend + block-0 kernel pair."""
        bn = self.first_bn
        return fused_frontend_block0(
            x, self.filterbank, {"weight": bn.weight, "bias": bn.bias},
            {"mean": bn.running_mean, "var": bn.running_var},
            self.encoder[0])

    def _branch(self, tag: str, out_t, out_s, master):
        l1 = getattr(self, f"HtrgGAT_layer_ST{tag}1")
        l2 = getattr(self, f"HtrgGAT_layer_ST{tag}2")
        # the raw (1, 1, D) master parameter goes in as is (broadcast)
        o_t, o_s, m = l1(out_t, out_s, master)
        o_s = getattr(self, f"pool_hS{tag}")(o_s)
        o_t = getattr(self, f"pool_hT{tag}")(o_t)
        t_aug, s_aug, m_aug = l2(o_t, o_s, m)
        return o_t + t_aug, o_s + s_aug, m + m_aug

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) waveform -> (last_hidden (B, 5 * g1), logits (B, 2))."""
        if self.training and self.use_fused_stack:
            raise RuntimeError("use_fused_stack is eval only: the frontend "
                               "+ block-0 kernel pair has no backward")
        if self.training:
            raise NotImplementedError(
                "only the eval forward is ported; call model.eval() "
                "(training comes in a later slice, see ROADMAP.md)")
        x = x.to(self.filterbank.dtype).contiguous()
        if self.use_fused_stack:
            e, blocks = self.fused_stack(x), self.encoder[1:]
        else:
            e, blocks = self.frontend(x), self.encoder
        for block in blocks:
            e = block(e)                                      # (B,C,F,T)

        e_s = e.abs().amax(dim=3).transpose(1, 2) + self.pos_S   # (B,F,C)
        out_s = self.pool_S(self.GAT_layer_S(e_s))
        e_t = e.abs().amax(dim=2).transpose(1, 2)                 # (B,T,C)
        out_t = self.pool_T(self.GAT_layer_T(e_t))

        # the JAX eval forward vmaps the two branches; same math in turn
        out_t1, out_s1, master1 = self._branch("1", out_t, out_s,
                                               self.master1)
        out_t2, out_s2, master2 = self._branch("2", out_t, out_s,
                                               self.master2)
        out_t = torch.maximum(out_t1, out_t2)
        out_s = torch.maximum(out_s1, out_s2)
        master = torch.maximum(master1, master2)

        last_hidden = torch.cat(
            [out_t.abs().amax(dim=1), out_t.mean(dim=1),
             out_s.abs().amax(dim=1), out_s.mean(dim=1), master[:, 0]],
            dim=1)
        return last_hidden, self.out_layer(last_hidden)


def count_params(model: tnn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
