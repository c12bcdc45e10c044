"""Plain PyTorch reference of SSL-AASIST's eval forward, written from the
published descriptions and code, not from the port:

  * the front end is fairseq's ``Wav2Vec2Model`` as XLS-R 300M configures
    it (``xlsr2_300m``: ``extractor_mode=layer_norm``,
    ``layer_norm_first=True``, ``conv_bias=True``), run ``features_only``
    with no mask;
  * the back end is TakHemlata/SSL_Anti-spoofing ``model.py`` (``Model``,
    ``Residual_block``, the graph layers it shares with clovaai/aasist).

A function of a flat dict of float32 tensors, named as the port's
``models/ssl_aasist.py`` names its parameters, in float32 with TF32 off
(``forward`` sets both switches off and restores them).  Attention is
written out, ``softmax(q k^T / sqrt(head size)) v``; convolutions are
``F.conv1d`` / ``F.conv2d``.  It imports nothing of either package.

Departures from the source, as the port makes them: the position conv
holds its folded weight (fairseq keeps it under weight norm, ``weight_g``
and ``weight_v``); the waveform goes in raw, as SSL_Anti-spoofing feeds
it.  The source's quirks are kept: the residual block convolves its raw
input (``bn1`` never reaches the output) and has no max pool, the graph
attention's softmax runs over the source-node axis, both cross blocks of
the heterogeneous attention use ``att_weight12``, graph pooling keeps its
nodes in descending-score order.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
Params = Dict[str, torch.Tensor]


def _layer_norm(x: torch.Tensor, P: Params, name: str) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in float32."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + EPS) * P[f"{name}.weight"]
            + P[f"{name}.bias"])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _linear(x: torch.Tensor, P: Params, name: str) -> torch.Tensor:
    return x @ P[f"{name}.weight"].T + P[f"{name}.bias"]


def _batch_norm(x: torch.Tensor, P: Params, name: str, axis: int
                ) -> torch.Tensor:
    """Eval-mode BatchNorm over ``axis``."""
    shape = [1] * x.dim()
    shape[axis] = -1

    def v(key):
        return P[f"{name}.{key}"].reshape(shape)

    return ((x - v("running_mean")) / torch.sqrt(v("running_var") + EPS)
            * v("weight") + v("bias"))


def _selu(x: torch.Tensor) -> torch.Tensor:
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    return scale * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


# ------------------------------------------------------------ front end
def _attention(x: torch.Tensor, P: Params, name: str, heads: int
               ) -> torch.Tensor:
    b, s, d = x.shape
    dh = d // heads

    def split(t):
        return t.reshape(b, s, heads, dh).permute(0, 2, 1, 3)

    q = split(_linear(x, P, f"{name}.q_proj")) / math.sqrt(dh)
    k = split(_linear(x, P, f"{name}.k_proj"))
    v = split(_linear(x, P, f"{name}.v_proj"))
    a = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    o = (a @ v).permute(0, 2, 1, 3).reshape(b, s, d)
    return _linear(o, P, f"{name}.out_proj")


def xlsr(P: Params, x: torch.Tensor, mc) -> torch.Tensor:
    """(B, L) raw waveform -> (B, T, D), the last layer's normed output."""
    h = x[:, None, :]
    for i, (_dim, _k, stride) in enumerate(mc["conv_feature_layers"]):
        h = F.conv1d(h, P[f"ssl.conv.{i}.weight"], P[f"ssl.conv.{i}.bias"],
                     stride=stride)
        # LayerNorm over channels at each frame, then GELU
        h = _gelu(_layer_norm(h.transpose(1, 2), P, f"ssl.conv_norm.{i}")
                  ).transpose(1, 2)
    y = _linear(_layer_norm(h.transpose(1, 2), P, "ssl.layer_norm"), P,
                "ssl.post_extract_proj")
    k = mc["conv_pos"]
    pos = F.conv1d(y.transpose(1, 2), P["ssl.pos_conv.weight"],
                   P["ssl.pos_conv.bias"], padding=k // 2,
                   groups=mc["conv_pos_groups"])
    if k % 2 == 0:
        pos = pos[..., :-1]             # fairseq's SamePad
    y = y + _gelu(pos).transpose(1, 2)
    for j in range(mc["encoder_layers"]):
        p = f"ssl.layers.{j}"
        y = y + _attention(_layer_norm(y, P, f"{p}.self_attn_layer_norm"),
                           P, f"{p}.self_attn",
                           mc["encoder_attention_heads"])
        f = _layer_norm(y, P, f"{p}.final_layer_norm")
        y = y + _linear(_gelu(_linear(f, P, f"{p}.fc1")), P, f"{p}.fc2")
    return _layer_norm(y, P, "ssl.encoder_layer_norm")


# ------------------------------------------------------------- back end
def _conv2d(x, P, name, padding):
    return F.conv2d(x, P[f"{name}.weight"], P[f"{name}.bias"],
                    padding=padding)


def _residual_block(x, P, name, cin, cout):
    out = _selu(_batch_norm(_conv2d(x, P, f"{name}.conv1", (1, 1)), P,
                            f"{name}.bn2", 1))
    out = _conv2d(out, P, f"{name}.conv2", (0, 1))
    if cin != cout:
        x = _conv2d(x, P, f"{name}.conv_downsample", (0, 1))
    return out + x


def _gat(x, P, name, temp):
    pair = x[:, :, None, :] * x[:, None, :, :]
    a = torch.tanh(_linear(pair, P, f"{name}.att_proj")) @ P[
        f"{name}.att_weight"]
    a = torch.softmax(a / temp, dim=-2)[..., 0]
    y = (_linear(a @ x, P, f"{name}.proj_with_att")
         + _linear(x, P, f"{name}.proj_without_att"))
    return _selu(_batch_norm(y, P, f"{name}.bn", -1))


def _htrg_gat(x1, x2, master, P, name, temp):
    n1 = x1.shape[1]
    x = torch.cat([_linear(x1, P, f"{name}.proj_type1"),
                   _linear(x2, P, f"{name}.proj_type2")], dim=1)
    pair = x[:, :, None, :] * x[:, None, :, :]
    a = torch.tanh(_linear(pair, P, f"{name}.att_proj"))
    s11, s22, s12 = (a @ P[f"{name}.att_weight{w}"]
                     for w in ("11", "22", "12"))
    att = torch.cat([torch.cat([s11[:, :n1, :n1], s12[:, :n1, n1:]], 2),
                     torch.cat([s12[:, n1:, :n1], s22[:, n1:, n1:]], 2)], 1)
    att = torch.softmax(att / temp, dim=-2)[..., 0]
    am = torch.tanh(_linear(x * master, P, f"{name}.att_projM"))
    am = torch.softmax(am @ P[f"{name}.att_weightM"] / temp, dim=-2)
    new_master = (_linear(am.transpose(1, 2) @ x, P,
                          f"{name}.proj_with_attM")
                  + _linear(master, P, f"{name}.proj_without_attM"))
    y = (_linear(att @ x, P, f"{name}.proj_with_att")
         + _linear(x, P, f"{name}.proj_without_att"))
    y = _selu(_batch_norm(y, P, f"{name}.bn", -1))
    return y[:, :n1], y[:, n1:], new_master


def _graph_pool(h, P, name, k):
    scores = torch.sigmoid(_linear(h, P, f"{name}.proj"))
    keep = max(int(h.shape[1] * k), 1)
    idx = torch.topk(scores[..., 0], keep, dim=1, sorted=True).indices
    h = h * scores
    return torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))


def back_end(P: Params, y: torch.Tensor, mc
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D) embedding -> (last_hidden, logits)."""
    filts, r, t = mc["filts"], mc["pool_ratios"], mc["temperatures"]
    e = _linear(y, P, "LL").transpose(1, 2)[:, None]
    e = _selu(_batch_norm(F.max_pool2d(e, (3, 3)), P, "first_bn", 1))
    plan = [filts[1], filts[2], filts[3], filts[4], filts[4], filts[4]]
    for i, (cin, cout) in enumerate(plan):
        e = _residual_block(e, P, f"encoder.{i}", cin, cout)
    e = _selu(_batch_norm(e, P, "first_bn1", 1))
    w = _selu(_conv2d(e, P, "attention.0", 0))
    w = _conv2d(_batch_norm(w, P, "attention.2", 1), P, "attention.3", 0)
    e_s = torch.sum(e * torch.softmax(w, dim=-1), dim=-1).transpose(1, 2)
    out_s = _graph_pool(_gat(e_s + P["pos_S"], P, "GAT_layer_S", t[0]), P,
                        "pool_S", r[0])
    e_t = torch.sum(e * torch.softmax(w, dim=-2), dim=-2).transpose(1, 2)
    out_t = _graph_pool(_gat(e_t, P, "GAT_layer_T", t[1]), P, "pool_T", r[1])
    outs = []
    for b in ("1", "2"):
        o_t, o_s, m = _htrg_gat(out_t, out_s, P[f"master{b}"], P,
                                f"HtrgGAT_layer_ST{b}1", t[2])
        o_s = _graph_pool(o_s, P, f"pool_hS{b}", r[2])
        o_t = _graph_pool(o_t, P, f"pool_hT{b}", r[2])
        t_aug, s_aug, m_aug = _htrg_gat(o_t, o_s, m, P,
                                        f"HtrgGAT_layer_ST{b}2", t[2])
        outs.append((o_t + t_aug, o_s + s_aug, m + m_aug))
    (t1, s1, m1), (t2, s2, m2) = outs
    out_t, out_s = torch.max(t1, t2), torch.max(s1, s2)
    master = torch.max(m1, m2)
    hidden = torch.cat([out_t.abs().max(dim=1)[0], out_t.mean(dim=1),
                        out_s.abs().max(dim=1)[0], out_s.mean(dim=1),
                        master[:, 0]], dim=1)
    return hidden, _linear(hidden, P, "out_layer")


def forward(P: Params, x: torch.Tensor, mc
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) float32 waveforms -> (last_hidden (B, 5 * g1), logits (B,
    2)), with TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return back_end(P, xlsr(P, x, mc), mc)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
