"""Plain PyTorch reference of SSL-AASIST (Tak et al., Odyssey 2022:
TakHemlata/SSL_Anti-spoofing ``model.py``), eval forward, in float32,
for the benchmark's output check.  The same mathematics as the repo's
reference (``tests/ssl_aasist_reference.py``), in this harness's interface.

Front end: XLS-R 300M, fairseq ``Wav2Vec2Model`` with
``extractor_mode=layer_norm``, ``layer_norm_first``, ``conv_bias``,
``features_only`` and no mask: seven conv blocks (conv, LayerNorm over
channels, exact GELU), LayerNorm and the projection to
``encoder_embed_dim``, the grouped position conv (its even kernel's last
frame dropped) through GELU added, ``encoder_layers`` pre-LN layers with
the attention written out, ``softmax(q k^T / sqrt(head size)) v``, and the
final LayerNorm.  Back end: ``LL``, max pool (3, 3), ``first_bn`` and
SELU, six residual blocks without max pool, ``first_bn1`` and SELU, the
1x1 ``attention`` weights, the spectral and temporal nodes as
attention-weighted sums, then AASIST's graph layers
(``portbench/reference/aasist.py``'s, quirks and all).

Departures from the source: the position conv holds its folded weight
(fairseq keeps it under weight norm); the waveform goes in raw, as the
source feeds it.

Names are the program's (``aasist_tpu_torch/models/ssl_aasist.py``), so
one dict of weights fills both.  ``q`` (default: the identity) is applied
to both operands of every product (conv, linear, matmul): the scoring
control passes a rounding to fp8.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import aasist as base
from portbench.reference.aasist import crop_or_tile, fp8  # noqa: F401

LN_EPS = 1e-5
Params = Dict[str, torch.Tensor]
_ident = base._ident


def param_shapes(mc) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every tensor of the model: name -> (shape, kind), the kinds of
    ``portbench/lib/weights.py:make``; LayerNorm's gamma and beta are
    ``bn_weight`` and ``bn_bias``, the graph pools' projection weights
    ``bias``."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def affine(name, shape, bias=True):
        out[f"{name}.weight"] = (shape, "weight")
        if bias:
            out[f"{name}.bias"] = ((shape[0],), "bias")

    def ln(name, c):
        out[f"{name}.weight"] = ((c,), "bn_weight")
        out[f"{name}.bias"] = ((c,), "bn_bias")

    def bn(name, c):
        ln(name, c)
        out[f"{name}.running_mean"] = ((c,), "bn_mean")
        out[f"{name}.running_var"] = ((c,), "bn_var")

    cin = 1
    for i, (dim, k, _) in enumerate(mc["conv_feature_layers"]):
        affine(f"ssl.conv.{i}", (dim, cin, k))
        ln(f"ssl.conv_norm.{i}", dim)
        cin = dim
    d, ffn = mc["encoder_embed_dim"], mc["encoder_ffn_embed_dim"]
    ln("ssl.layer_norm", cin)
    affine("ssl.post_extract_proj", (d, cin))
    affine("ssl.pos_conv", (d, d // mc["conv_pos_groups"], mc["conv_pos"]))
    for j in range(mc["encoder_layers"]):
        p = f"ssl.layers.{j}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            affine(f"{p}.self_attn.{proj}", (d, d))
        ln(f"{p}.self_attn_layer_norm", d)
        affine(f"{p}.fc1", (ffn, d))
        affine(f"{p}.fc2", (d, ffn))
        ln(f"{p}.final_layer_norm", d)
    ln("ssl.encoder_layer_norm", d)
    filts = mc["filts"]
    d_enc = filts[-1][-1]
    affine("LL", (filts[0], d))
    # first_bn, the six residual blocks, pos_S, the master nodes and the
    # graph layers are AASIST's, by name and shape
    out.update(base.param_shapes(mc))
    # the graph pools' projections drawn at the biases' scale: drawn
    # fan-in scaled, on the unpooled encoder's large activations their
    # logits lie far from zero (|mean| 9-11, spread 1.3-1.6), so a 1.5 %
    # rounding of the nodes moves a logit past its neighbours and the
    # pools keep other nodes in bf16 than in f32 (then bf16 reads farther
    # from the f32 reference than fp8 does)
    for name in ("pool_S", "pool_T", "pool_hS1", "pool_hT1", "pool_hS2",
                 "pool_hT2"):
        shape, _ = out[f"{name}.proj.weight"]
        out[f"{name}.proj.weight"] = (shape, "bias")
    bn("first_bn1", d_enc)
    affine("attention.0", (2 * d_enc, d_enc, 1, 1))
    bn("attention.2", 2 * d_enc)
    affine("attention.3", (d_enc, 2 * d_enc, 1, 1))
    return out


class _Net(base._Net):
    """AASIST's reference layers, with the residual block of
    SSL_Anti-spoofing (no max pool) and LayerNorm."""

    def residual(self, x, p, cin, cout):
        out = torch.selu(self.bn(self.conv(x, f"{p}.conv1", (1, 1)),
                                 f"{p}.bn2", 1))
        out = self.conv(out, f"{p}.conv2", (0, 1))
        ident = (self.conv(x, f"{p}.conv_downsample", (0, 1))
                 if cin != cout else x)
        return out + ident

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.P[f"{name}.weight"],
                            self.P[f"{name}.bias"], eps=LN_EPS)

    def conv1d(self, x, name, **kw):
        return F.conv1d(self.q(x), self.q(self.P[f"{name}.weight"]),
                        self.P[f"{name}.bias"], **kw)

    def attention(self, x, p, heads):
        b, s, d = x.shape
        dh = d // heads
        q, k, v = (self.lin(x, f"{p}.{n}").reshape(b, s, heads, dh)
                   .transpose(1, 2) for n in ("q_proj", "k_proj", "v_proj"))
        a = torch.softmax(self.mm(q, k.transpose(-1, -2)) / dh ** 0.5,
                          dim=-1)
        o = self.mm(a, v).transpose(1, 2).reshape(b, s, d)
        return self.lin(o, f"{p}.out_proj")


def xlsr(net: _Net, x: torch.Tensor, mc) -> torch.Tensor:
    """(B, L) waveforms -> (B, T, D) embedding."""
    h = x[:, None, :]
    for i, (_, _, stride) in enumerate(mc["conv_feature_layers"]):
        h = net.conv1d(h, f"ssl.conv.{i}", stride=stride)
        h = F.gelu(net.ln(h.transpose(1, 2), f"ssl.conv_norm.{i}"))
        h = h.transpose(1, 2)
    y = net.lin(net.ln(h.transpose(1, 2), "ssl.layer_norm"),
                "ssl.post_extract_proj")
    t, k = y.shape[1], mc["conv_pos"]
    pos = net.conv1d(y.transpose(1, 2), "ssl.pos_conv", padding=k // 2,
                     groups=mc["conv_pos_groups"])[..., :t]
    y = y + F.gelu(pos).transpose(1, 2)
    for j in range(mc["encoder_layers"]):
        p = f"ssl.layers.{j}"
        y = y + net.attention(net.ln(y, f"{p}.self_attn_layer_norm"),
                              f"{p}.self_attn",
                              mc["encoder_attention_heads"])
        f = net.ln(y, f"{p}.final_layer_norm")
        y = y + net.lin(F.gelu(net.lin(f, f"{p}.fc1")), f"{p}.fc2")
    return net.ln(y, "ssl.encoder_layer_norm")


def forward(P: Params, x: torch.Tensor, mc, *, q: Callable = _ident
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) float32 waveforms -> (last_hidden (B, 5 g1), logits (B,
    2))."""
    net = _Net(P, q, None)
    filts = mc["filts"]
    r = mc["pool_ratios"]
    t = mc["temperatures"]
    e = net.lin(xlsr(net, x, mc), "LL").transpose(1, 2)[:, None]
    e = torch.selu(net.bn(F.max_pool2d(e, 3), "first_bn", 1))
    for i, (cin, cout) in enumerate(base.encoder_plan(filts)):
        e = net.residual(e, f"encoder.{i}", cin, cout)
    e = torch.selu(net.bn(e, "first_bn1", 1))
    w = torch.selu(net.conv(e, "attention.0", 0))
    w = net.conv(net.bn(w, "attention.2", 1), "attention.3", 0)

    e_s = (e * torch.softmax(w, dim=-1)).sum(dim=-1).transpose(1, 2)
    out_s = net.pool(net.gat(e_s + P["pos_S"], "GAT_layer_S", t[0]),
                     "pool_S", r[0])
    e_t = (e * torch.softmax(w, dim=-2)).sum(dim=-2).transpose(1, 2)
    out_t = net.pool(net.gat(e_t, "GAT_layer_T", t[1]), "pool_T", r[1])

    branches = []
    for tag in ("1", "2"):
        o_t, o_s, m = net.htrg(out_t, out_s, P[f"master{tag}"],
                               f"HtrgGAT_layer_ST{tag}1", t[2])
        o_s = net.pool(o_s, f"pool_hS{tag}", r[2])
        o_t = net.pool(o_t, f"pool_hT{tag}", r[2])
        t_aug, s_aug, m_aug = net.htrg(o_t, o_s, m,
                                       f"HtrgGAT_layer_ST{tag}2", t[2])
        branches.append((o_t + t_aug, o_s + s_aug, m + m_aug))
    (t1, s1, m1), (t2, s2, m2) = branches
    out_t, out_s, master = (torch.maximum(t1, t2), torch.maximum(s1, s2),
                            torch.maximum(m1, m2))
    hidden = torch.cat([out_t.abs().amax(dim=1), out_t.mean(dim=1),
                        out_s.abs().amax(dim=1), out_s.mean(dim=1),
                        master[:, 0]], dim=1)
    return hidden, net.lin(hidden, "out_layer")


def score_rows(P: Params, rows: np.ndarray, mc, *, device, block: int,
               q: Callable = _ident) -> np.ndarray:
    """Bonafide scores (logits[:, 1]) of (n, L) float32 rows, ``block``
    rows at a time, in float32 with TF32 off (restored after)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        with torch.inference_mode():
            for i in range(0, rows.shape[0], block):
                x = torch.from_numpy(rows[i:i + block]).to(device)
                out.append(forward(P, x, mc, q=q)[1][:, 1].float()
                           .cpu().numpy())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    return np.concatenate(out) if out else np.zeros((0,), np.float32)
