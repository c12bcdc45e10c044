"""SSL-AASIST: a wav2vec 2.0 XLS-R front end under the AASIST back end,
eval forward (Tak et al., "Automatic speaker verification spoofing and
deepfake detection using wav2vec 2.0 and data augmentation", Odyssey 2022;
github.com/TakHemlata/SSL_Anti-spoofing ``model.py``).  The JAX package has
no counterpart: the port's own architecture.

Dataflow at the published widths (fairseq ``xlsr2_300m``, HF
``facebook/wav2vec2-xls-r-300m``) at (B, 64600):
  raw waveform (no per-utterance normalisation, as the source feeds it)
  7 x [Conv1d (k, stride, bias) -> LayerNorm over channels -> GELU]
     k = 10, 3, 3, 3, 3, 2, 2; stride 5, 2, 2, 2, 2, 2, 2   -> (B, 201, 512)
  LayerNorm(512) -> Linear(512, 1024)                        -> (B, 201, 1024)
  + GELU(grouped position conv, 128 taps, 16 groups; last frame dropped)
  24 pre-LN layers: x + MHA(LN(x)) (16 heads of 64, scaled dot-product
     attention), x + fc2(GELU(fc1(LN(x)))) (1024 -> 4096 -> 1024)
  LayerNorm(1024)                                            -> (B, 201, 1024)
  LL Linear(1024, 128), as (B, 1, 128, 201) -> max pool (3, 3) -> first_bn
     -> SELU                                                 -> (B, 1, 42, 67)
  6 residual blocks without their (1, 3) max pool            -> (B, 64, 42, 67)
  first_bn1 -> SELU; w = attention(x) (1x1 conv, SELU, BN, 1x1 conv)
  spectral nodes sum_t x softmax_t(w), + pos_S -> GAT -> pool (21 nodes)
  temporal nodes sum_f x softmax_f(w)          -> GAT -> pool (33 nodes)
  AASIST's two HS-GAL branches, readout and out_layer -> (B, 160), (B, 2).

Departures from the source: the position conv holds its folded weight (a
loader of the published checkpoint folds fairseq's weight norm, ``g * v /
|v|`` over dims 0 and 1); eval only (fine-tuning is not ported:
``train()`` raises).  LayerNorm's statistics are f32 in any
dtype (PyTorch's kernels accumulate in f32, as fairseq's ``Fp32LayerNorm``).

Parameter names are one flat scheme, shared with the plain references
(``tests/ssl_aasist_reference.py``, ``portbench/reference/ssl_aasist.py``):
the front end under ``ssl.``, the back end as SSL_Anti-spoofing names it
(``LL``, ``first_bn1``, ``attention.0`` / ``.2`` / ``.3``) and as AASIST
names the shared layers (``encoder.<i>.conv1``, ``GAT_layer_S``, ...).

The attention runs through ``F.scaled_dot_product_attention``; on a card
only its fused backends (flash, memory-efficient, cuDNN) are allowed, so a
shape or type none of them takes raises instead of falling back to the
math path.  ``model.ssl.attention_calls`` counts the attention calls of the
last forward and ``model.ssl.sdpa_backend`` names the backend SDPA picks
for them.  Under a profiler the stages are the spans ``model.ssl.features``
(conv extractor and projection), ``model.ssl.encoder`` (its args: the frame
count and the backend), ``model.head`` (``LL`` to the first SELU),
``model.block0``-``model.block5`` and ``model.graph``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn
from torch.nn.attention import SDPBackend, sdpa_kernel

from aasist_tpu_torch import nn
from aasist_tpu_torch.models import layers as L
from aasist_tpu_torch.models.aasist import hs_gal, readout
from aasist_tpu_torch.utils.profiling import annotate

# the backends a card may run the attention on: never the math fallback
FUSED_SDPA = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION]


def sdpa_backend(q: torch.Tensor) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for query, key
    and value of ``q``'s shape, strides, type and device under the
    backends allowed now.  It asks PyTorch's private
    ``torch._fused_sdp_choice``, which may change between releases, and
    names what SDPA would pick, not a kernel seen to run: the card test
    ``tests/test_torch_scorer_cuda.py`` holds it against a trace's kernel
    names."""
    return SDPBackend(torch._fused_sdp_choice(q, q, q)).name


class SelfAttention(tnn.Module):
    """Multi-head self-attention with biased q, k, v and out projections,
    scale 1 / sqrt(head size)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = tnn.Linear(dim, dim)
        self.k_proj = tnn.Linear(dim, dim)
        self.v_proj = tnn.Linear(dim, dim)
        self.out_proj = tnn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, attend) -> torch.Tensor:
        b, s, d = x.shape
        q, k, v = (p(x).view(b, s, self.heads, d // self.heads)
                   .transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(attend(q, k, v).transpose(1, 2).reshape(b, s, d))


class EncoderLayer(tnn.Module):
    """fairseq's ``TransformerSentenceEncoderLayer`` with
    ``layer_norm_first``: x + MHA(LN(x)), then x + fc2(GELU(fc1(LN(x))))."""

    def __init__(self, dim: int, heads: int, ffn: int):
        super().__init__()
        self.self_attn = SelfAttention(dim, heads)
        self.self_attn_layer_norm = tnn.LayerNorm(dim)
        self.fc1 = tnn.Linear(dim, ffn)
        self.fc2 = tnn.Linear(ffn, dim)
        self.final_layer_norm = tnn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, attend) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), attend)
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class XlsrFrontend(tnn.Module):
    """wav2vec 2.0 (``extractor_mode=layer_norm``, ``layer_norm_first``,
    ``conv_bias``) from the raw waveform to the last layer's normed output,
    ``features_only``: no masking, no quantiser."""

    def __init__(self, mc: Dict[str, Any]):
        super().__init__()
        self.conv = tnn.ModuleList()
        self.conv_norm = tnn.ModuleList()
        cin = 1
        for dim, k, stride in mc["conv_feature_layers"]:
            self.conv.append(tnn.Conv1d(cin, dim, k, stride=stride))
            self.conv_norm.append(tnn.LayerNorm(dim))
            cin = dim
        d = mc["encoder_embed_dim"]
        self.heads = mc["encoder_attention_heads"]
        self.layer_norm = tnn.LayerNorm(cin)
        self.post_extract_proj = tnn.Linear(cin, d)
        self.pos_conv = tnn.Conv1d(d, d, mc["conv_pos"],
                                   padding=mc["conv_pos"] // 2,
                                   groups=mc["conv_pos_groups"])
        self.layers = tnn.ModuleList(
            EncoderLayer(d, self.heads, mc["encoder_ffn_embed_dim"])
            for _ in range(mc["encoder_layers"]))
        self.encoder_layer_norm = tnn.LayerNorm(d)
        self.attention_calls = 0
        self.sdpa_backend: Optional[str] = None

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) waveform -> (B, T, D) projected conv features."""
        h = x[:, None, :]
        for conv, norm in zip(self.conv, self.conv_norm):
            y = F.gelu(norm(conv(h).transpose(1, 2)))       # (B, T, C)
            h = y.transpose(1, 2)
        return self.post_extract_proj(self.layer_norm(y))

    def _attend(self, q, k, v) -> torch.Tensor:
        self.attention_calls += 1
        return F.scaled_dot_product_attention(q, k, v)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) features -> (B, T, D) embedding: the position conv's
        GELU added, the layers, the final LayerNorm."""
        b, t, d = x.shape
        with (sdpa_kernel(FUSED_SDPA) if x.is_cuda
              else contextlib.nullcontext()):
            # query, key and value are laid out as this view of x is
            self.sdpa_backend = sdpa_backend(
                x.view(b, t, self.heads, d // self.heads).transpose(1, 2))
            self.attention_calls = 0
            with annotate("model.ssl.encoder",
                          f"frames={t} sdpa={self.sdpa_backend}"):
                # padding K // 2 each side: an even kernel's extra frame
                # falls off the end
                pos = self.pos_conv(x.transpose(1, 2))[..., :t]
                x = x + F.gelu(pos).transpose(1, 2)
                for layer in self.layers:
                    x = layer(x, self._attend)
                return self.encoder_layer_norm(x)


class SslAasistModel(tnn.Module):
    """SSL-AASIST, eval only: ``forward`` keeps ``AasistModel.forward``'s
    contract, (B, L) waveform -> (last_hidden (B, 5 * g1), logits (B,
    2))."""

    def __init__(self, model_config: Dict[str, Any]):
        super().__init__()
        self.config = dict(model_config)
        filts = model_config["filts"]
        g0, g1 = model_config["gat_dims"]
        r = model_config["pool_ratios"]
        t = model_config["temperatures"]
        d_enc = filts[-1][-1]
        self.ssl = XlsrFrontend(model_config)
        self.LL = tnn.Linear(model_config["encoder_embed_dim"], filts[0])
        self.first_bn = tnn.BatchNorm2d(1)
        self.encoder = L.residual_encoder(filts, pool=False)
        self.first_bn1 = tnn.BatchNorm2d(d_enc)
        self.attention = tnn.Sequential(
            tnn.Conv2d(d_enc, 2 * d_enc, 1), tnn.SELU(),
            tnn.BatchNorm2d(2 * d_enc), tnn.Conv2d(2 * d_enc, d_enc, 1))
        # one spectral node per pooled LL row (42 at filts[0] = 128)
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
        self.eval()

    def train(self, mode: bool = True) -> "SslAasistModel":
        if mode:
            raise RuntimeError("SSL_AASIST is eval only: its fine-tuning is "
                               "not ported")
        return super().train(False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) waveform -> (last_hidden (B, 5 * g1), logits (B, 2))."""
        x = x.to(self.LL.weight.dtype).contiguous()
        with annotate("model.ssl.features"):
            h = self.ssl.features(x)
        h = self.ssl.encode(h)                                # (B, T, D)
        with annotate("model.head"):
            e = self.LL(h).transpose(1, 2)[:, None]           # (B,1,F,T)
            e = nn.batch_norm(self.first_bn, nn.max_pool(e, (3, 3)), axis=1)
            e = nn.selu(e)
        e = L.run_encoder(self.encoder, e, remat=False)       # (B,C,F,T)
        with annotate("model.graph"):
            e = nn.selu(nn.batch_norm(self.first_bn1, e, axis=1))
            w = self.attention(e)
            e_s = (e * torch.softmax(w, dim=-1)).sum(dim=-1)  # (B,C,F)
            e_s = e_s.transpose(1, 2) + self.pos_S
            out_s = self.pool_S(self.GAT_layer_S(e_s))
            e_t = (e * torch.softmax(w, dim=-2)).sum(dim=-2)  # (B,C,T)
            out_t = self.pool_T(self.GAT_layer_T(e_t.transpose(1, 2)))
            out_t, out_s, master = hs_gal(self, out_t, out_s)
            last_hidden = torch.cat(readout(out_t, out_s) + [master[:, 0]],
                                    dim=1)
            return last_hidden, self.out_layer(last_hidden)
