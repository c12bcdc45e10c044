"""AASIST / AASIST-L / AASIST2 forward, eval and train (counterpart of
``aasist_tpu/models/aasist.py``).

Dataflow for AASIST.conf at (B, 64600):
  sinc conv (70 x 129) -> |.| -> maxpool (3,3) -> first_bn -> selu
                                                   -> (B, 1, 23, 21490)
  6 residual blocks (AASIST2: Res2Net + SE blocks) -> (B, 64, 23, 29)
  spectral view: max|e| over time, + pos_S -> GAT -> pool
  temporal view: max|e| over freq          -> GAT -> pool
  2 x (HtrgGAT -> pool -> HtrgGAT + residual) branches with master nodes,
  fused by elementwise max; [AASIST2, frame level: speaker conditioning of
  both node sets]; readout [max|T|, mean T, max|S|, mean S, master]
  -> (B, 5 * gat_dims[1]) -> Linear -> 2 logits.

The encoder is chosen as the JAX model chooses it: ``encoder`` in the
config, else Res2Net when a ``res2net_*`` key is present (AASIST2.conf keeps
``architecture: AASIST``).  The model computes in the dtype it was cast to
(``model.to(torch.bfloat16)`` casts the filterbank buffer with the
weights).  Parameter names are the JAX tree's paths
(``encoder.0.conv1.weight``, ``first_bn.running_mean``).

In train mode (``model.train()``) the forward takes the stock sinc conv
path whatever ``use_fused_frontend`` says (the kernel has no backward, as
in the JAX package), BatchNorm uses batch statistics and moves its running
ones, ``freq_aug`` masks the filterbank, and the dropouts of the JAX
forward apply, drawn from the ``rngs`` stream: the graph layers', then 0.2
on each branch's temporal and spectral nodes and master, 0.5 on
``last_hidden``.  ``remat`` (default on) recomputes each encoder block in
the backward.  Models are built in eval mode; a trainer calls ``train()``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from aasist_tpu_torch import nn
from aasist_tpu_torch.models import layers as L
from aasist_tpu_torch.ops.fused_frontend import fused_frontend_mesh
from aasist_tpu_torch.ops.fused_stack import fused_frontend_block0
from aasist_tpu_torch.utils.profiling import annotate


class SincFrontendModel(tnn.Module):
    """The sinc frontend of AASIST, AASIST-Robust and RawGAT-ST: the fixed
    filterbank (a buffer, not in checkpoints), ``first_bn``, and
    ``frontend``, which ``use_fused_frontend`` routes through the CUDA
    kernel (``ops/fused_frontend``) in eval mode, split over the devices of
    ``mesh`` when one is set (the JAX model's ``spmd_mesh``)."""

    def __init__(self, model_config: Dict[str, Any]):
        super().__init__()
        self.config = dict(model_config)
        self.use_fused_frontend = bool(
            model_config.get("use_fused_frontend", False))
        self.register_buffer("filterbank", torch.from_numpy(
            L.sinc_filterbank(model_config["filts"][0],
                              model_config["first_conv"])),
            persistent=False)
        self.first_bn = tnn.BatchNorm2d(1)
        self.mesh = None

    def frontend(self, x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
        """(B, L) waveform -> (B, 1, C // 3, (L - 128) // 3) through the
        filterbank ``bank`` (C, K)."""
        if self.use_fused_frontend and not self.training:
            bn = self.first_bn
            return fused_frontend_mesh(
                x, bank, {"weight": bn.weight, "bias": bn.bias},
                {"mean": bn.running_mean, "var": bn.running_var},
                mesh=self.mesh)
        h = L.sinc_frontend(bank, x).abs()[:, None]          # (B,1,C,L')
        h = nn.batch_norm(self.first_bn, nn.max_pool(h, (3, 3)), axis=1)
        return nn.selu(h)


def graph_views(m: tnn.Module, e: torch.Tensor,
                rngs: Optional[nn.RngStream] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The temporal and spectral graphs of AASIST and AASIST-Robust from
    the encoder output e (B, C, F, T): (pooled temporal nodes, pooled
    spectral nodes), through ``m``'s pos_S, GAT_layer_S / _T and pool_S /
    _T."""
    e_s = e.abs().amax(dim=3).transpose(1, 2) + m.pos_S       # (B,F,C)
    out_s = m.pool_S(m.GAT_layer_S(e_s, rngs), rngs)
    e_t = e.abs().amax(dim=2).transpose(1, 2)                 # (B,T,C)
    return m.pool_T(m.GAT_layer_T(e_t, rngs), rngs), out_s


def _hs_gal_branch(m: tnn.Module, tag: str, out_t: torch.Tensor,
                   out_s: torch.Tensor, master: torch.Tensor,
                   rngs: Optional[nn.RngStream] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One HS-GAL branch of AASIST through ``m``'s HtrgGAT_layer_ST<tag>1
    and _ST<tag>2 and pool_hS<tag> / pool_hT<tag>: (temporal nodes,
    spectral nodes, master)."""
    l1 = getattr(m, f"HtrgGAT_layer_ST{tag}1")
    l2 = getattr(m, f"HtrgGAT_layer_ST{tag}2")
    # the raw (1, 1, D) master parameter goes in as is (broadcast)
    o_t, o_s, mast = l1(out_t, out_s, master, rngs)
    o_s = getattr(m, f"pool_hS{tag}")(o_s, rngs)
    o_t = getattr(m, f"pool_hT{tag}")(o_t, rngs)
    t_aug, s_aug, m_aug = l2(o_t, o_s, mast, rngs)
    return o_t + t_aug, o_s + s_aug, mast + m_aug


def hs_gal(m: tnn.Module, out_t: torch.Tensor, out_s: torch.Tensor,
           rngs: Optional[nn.RngStream] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """AASIST's two HS-GAL branches from the pooled temporal and spectral
    nodes, started from ``m``'s master1 and master2 and fused by the
    element-wise max: (temporal nodes, spectral nodes, master).  In train
    mode each branch's outputs take a 0.2 dropout first."""
    # the JAX eval forward vmaps the two branches; same math in turn
    out_t1, out_s1, master1 = _hs_gal_branch(m, "1", out_t, out_s,
                                             m.master1, rngs)
    out_t2, out_s2, master2 = _hs_gal_branch(m, "2", out_t, out_s,
                                             m.master2, rngs)
    if m.training:
        out_t1, out_t2, out_s1, out_s2, master1, master2 = (
            nn.stream_dropout(rngs, t, 0.2, True)
            for t in (out_t1, out_t2, out_s1, out_s2, master1, master2))
    return (torch.maximum(out_t1, out_t2), torch.maximum(out_s1, out_s2),
            torch.maximum(master1, master2))


def readout(out_t: torch.Tensor, out_s: torch.Tensor) -> list:
    """[max|T|, mean T, max|S|, mean S] over the nodes."""
    return [out_t.abs().amax(dim=1), out_t.mean(dim=1),
            out_s.abs().amax(dim=1), out_s.mean(dim=1)]


class AasistModel(SincFrontendModel):
    """AASIST with the residual or the Res2Net encoder.

    ``use_fused_stack`` (eval only, default off in the config, on in the
    bf16 Scorer on a card: ``serving.kernel_route``; the key
    ``tools/fused_stack.py`` names) runs the frontend and residual block 0
    as the CUDA kernel pair of ``ops/fused_stack`` instead of the frontend
    and block 0, and takes precedence over ``use_fused_frontend``; the pair
    implements the residual block 0 only, so setting it on the Res2Net
    encoder raises (``has_fused_stack``).  ``b0_chunks`` is accepted and
    ignored: it split block 0 over the batch to fit TPU HBM, and the math
    is the same unchunked.
    """

    def __init__(self, model_config: Dict[str, Any]):
        super().__init__(model_config)
        self.encoder_type = model_config.get("encoder", "res2net" if (
            "res2net_width" in model_config
            or "res2net_scale" in model_config) else "residual")
        filts = model_config["filts"]
        g0, g1 = model_config["gat_dims"]
        r = model_config["pool_ratios"]
        t = model_config["temperatures"]
        d_enc = filts[-1][-1]
        if self.encoder_type == "residual":
            self.encoder = L.residual_encoder(filts)
        elif self.encoder_type == "res2net":
            self.encoder = L.res2net_encoder(
                filts, model_config.get("res2net_width", 14),
                model_config.get("res2net_scale", 8))
        else:
            raise ValueError(f"encoder {self.encoder_type!r}: residual or "
                             "res2net")
        self.remat = bool(model_config.get("remat", True))
        self.has_fused_stack = self.encoder_type == "residual"
        self.use_fused_stack = bool(
            model_config.get("use_fused_stack", False))

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
        self.spk_cond_gat = (L.SpeakerConditioning(
            model_config.get("spk_emb_dim", 256), g1,
            use_attention=bool(model_config.get("use_attention", True)),
            level=model_config.get("conditioning_level", "frame"))
            if model_config.get("speaker_conditioning") else None)
        self.eval()

    @property
    def use_fused_stack(self) -> bool:
        return self._use_fused_stack

    @use_fused_stack.setter
    def use_fused_stack(self, on: bool) -> None:
        if on and not self.has_fused_stack:
            raise ValueError(
                "use_fused_stack: the frontend + block-0 kernel pair "
                "implements the residual block 0 only, not the "
                f"{self.encoder_type} encoder")
        self._use_fused_stack = bool(on)

    def fused_stack(self, x: torch.Tensor, bank: torch.Tensor
                    ) -> torch.Tensor:
        """(B, L) waveform -> block 0's (B, C, C_bank // 3, (L - 128) // 9)
        through the frontend + block-0 kernel pair."""
        bn = self.first_bn
        return fused_frontend_block0(
            x, bank, {"weight": bn.weight, "bias": bn.bias},
            {"mean": bn.running_mean, "var": bn.running_var},
            self.encoder[0])

    def forward(self, x: torch.Tensor,
                speaker_embedding: Optional[torch.Tensor] = None, *,
                rngs: Optional[nn.RngStream] = None, freq_aug: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) waveform -> (last_hidden (B, 5 * g1), logits (B, 2)).
        ``speaker_embedding`` (B, spk_emb_dim) conditions a model built
        with ``speaker_conditioning``, at its ``conditioning_level``, and
        is ignored by any other.  ``rngs`` feeds the train-mode dropouts
        and ``freq_aug``'s mask.  Under a profiler its stages are the spans
        ``model.input``, ``model.frontend`` (``model.fused_stack`` on that
        route), one ``model.block<i>`` a block (``L.run_encoder``) and
        ``model.graph`` (the graph views through ``out_layer``)."""
        train = self.training
        if train and self.use_fused_stack:
            raise RuntimeError("use_fused_stack is eval only: the frontend "
                               "+ block-0 kernel pair has no backward")
        with annotate("model.input"):
            x, bank = L.model_input(self, x, rngs, freq_aug)
        if self.use_fused_stack:
            with annotate("model.fused_stack"):
                e = self.fused_stack(x, bank)
            blocks, first = self.encoder[1:], 1
        else:
            with annotate("model.frontend"):
                e = self.frontend(x, bank)
            blocks, first = self.encoder, 0
        e = L.run_encoder(blocks, e, self.remat, first)       # (B,C,F,T)
        with annotate("model.graph"):
            out_t, out_s = graph_views(self, e, rngs)
            out_t, out_s, master = hs_gal(self, out_t, out_s, rngs)

            cond = (self.spk_cond_gat if speaker_embedding is not None
                    else None)
            if cond is not None:
                speaker_embedding = speaker_embedding.to(x.dtype)
            if cond is not None and cond.level == "frame":
                out_t = cond(out_t, speaker_embedding)
                out_s = cond(out_s, speaker_embedding)
            last_hidden = torch.cat(readout(out_t, out_s) + [master[:, 0]],
                                    dim=1)
            if cond is not None and cond.level == "utterance":
                last_hidden = cond(last_hidden, speaker_embedding)
            last_hidden = nn.stream_dropout(rngs, last_hidden, 0.5, train)
            return last_hidden, self.out_layer(last_hidden)


def count_params(model: tnn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
