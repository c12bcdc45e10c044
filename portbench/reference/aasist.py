"""Plain PyTorch reference of AASIST and AASIST2 (the Res2Net encoder), in
float32, written from the published description and code (clovaai/aasist
``models/AASIST.py``; the AASIST2 fork's ``Res2Net`` + SE blocks).

It is a function of a flat parameter dict (``name -> tensor``) and holds
no state.  Names are the checkpoint's (``encoder.0.conv1.weight``,
``first_bn.running_mean``), so one dict of weights, made or loaded by the
benchmark, fills both this reference and the program under test.

The published code's quirks are kept, because the checkpoints were
trained with them: the graph-attention softmax runs over the source-node
axis (-2); both cross blocks of the heterogeneous attention use
``att_weight12``; graph pooling keeps its nodes in descending-score order;
the residual block computes ``bn1`` + SELU and then convolves the raw
input, so ``bn1`` never reaches the output; the Res2Net carry joins a split
only every ``scale`` splits.

``q`` (default: the identity) is applied to both operands of every
product (conv, linear, matmul, einsum): the control of a scoring cell
passes a rounding to fp8.  ``drop(x, p)`` is the train-mode dropout, called
at each dropout site in the published order; ``None`` means eval mode.
Speaker conditioning is not implemented: no benchmark cell runs it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
Params = Dict[str, torch.Tensor]


def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


# ------------------------------------------------------------ the shapes
def sinc_bank(out_channels: int, kernel_size: int,
              sample_rate: int = 16000) -> np.ndarray:
    """The fixed mel-spaced band-pass filterbank (out_channels, taps):
    Hamming-windowed differences of sincs, built in float64, cast to
    float32; an even ``kernel_size`` gets one more tap."""
    if kernel_size % 2 == 0:
        kernel_size += 1
    f = int(sample_rate / 2) * np.linspace(0, 1, 257)
    fmel = 2595.0 * np.log10(1.0 + f / 700.0)
    mel = np.linspace(fmel.min(), fmel.max(), out_channels + 1)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    n = np.arange(-(kernel_size - 1) / 2, (kernel_size - 1) / 2 + 1)
    window = np.hamming(kernel_size)
    bank = np.zeros((out_channels, kernel_size))
    for i in range(out_channels):
        hi = 2 * hz[i + 1] / sample_rate * np.sinc(2 * hz[i + 1] * n
                                                    / sample_rate)
        lo = 2 * hz[i] / sample_rate * np.sinc(2 * hz[i] * n / sample_rate)
        bank[i] = window * (hi - lo)
    return bank.astype(np.float32)


def encoder_plan(filts) -> List[Tuple[int, int]]:
    return [tuple(filts[1]), tuple(filts[2]), tuple(filts[3]),
            tuple(filts[4]), tuple(filts[4]), tuple(filts[4])]


def is_res2net(mc) -> bool:
    return mc.get("encoder", "res2net" if (
        "res2net_width" in mc or "res2net_scale" in mc) else "residual") \
        == "res2net"


def split_sizes(in_ch: int, width: int) -> List[int]:
    base = max(1, in_ch // width)
    return [base] * (width - 1) + [in_ch - base * (width - 1)]


def param_shapes(mc) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every tensor of the model: name -> (shape, kind), kind one of
    ``weight`` (fan-in scaled), ``bias``, ``bn_weight``, ``bn_bias``,
    ``bn_mean``, ``bn_var``, ``att`` (an attention vector) and ``free``
    (positional and master nodes)."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def conv(name, cin, cout, kh, kw, bias=True):
        out[f"{name}.weight"] = ((cout, cin, kh, kw), "weight")
        if bias:
            out[f"{name}.bias"] = ((cout,), "bias")

    def lin(name, din, dout, bias=True):
        out[f"{name}.weight"] = ((dout, din), "weight")
        if bias:
            out[f"{name}.bias"] = ((dout,), "bias")

    def bn(name, c):
        for t, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                        ("running_mean", "bn_mean"),
                        ("running_var", "bn_var")):
            out[f"{name}.{t}"] = ((c,), kind)

    filts = mc["filts"]
    g0, g1 = mc["gat_dims"]
    d_enc = filts[-1][-1]
    bn("first_bn", 1)
    for i, (cin, cout) in enumerate(encoder_plan(filts)):
        p = f"encoder.{i}"
        if is_res2net(mc):
            width = min(mc.get("res2net_width", 14), cin)
            for j, c in enumerate(split_sizes(cin, width)):
                conv(f"{p}.convs.{j}", c, c, 3, 3)
            conv(f"{p}.conv_cat", cin, cout, 3, 3)
            lin(f"{p}.se.fc.0", cout, cout // 16, bias=False)
            lin(f"{p}.se.fc.2", cout // 16, cout, bias=False)
            bn(f"{p}.bn2", cin)
        else:
            conv(f"{p}.conv1", cin, cout, 2, 3)
            conv(f"{p}.conv2", cout, cout, 2, 3)
            bn(f"{p}.bn2", cout)
        if i:
            bn(f"{p}.bn1", cin)
        if cin != cout:
            conv(f"{p}.conv_downsample", cin, cout, 1, 3)
    out["pos_S"] = ((1, filts[0] // 3, d_enc), "free")
    out["master1"] = ((1, 1, g0), "free")
    out["master2"] = ((1, 1, g0), "free")
    for name, din, dout in (("GAT_layer_S", d_enc, g0),
                            ("GAT_layer_T", d_enc, g0)):
        lin(f"{name}.att_proj", din, dout)
        out[f"{name}.att_weight"] = ((dout, 1), "att")
        lin(f"{name}.proj_with_att", din, dout)
        lin(f"{name}.proj_without_att", din, dout)
        bn(f"{name}.bn", dout)
    for tag, din in (("11", g0), ("12", g1), ("21", g0), ("22", g1)):
        name = f"HtrgGAT_layer_ST{tag}"
        lin(f"{name}.proj_type1", din, din)
        lin(f"{name}.proj_type2", din, din)
        lin(f"{name}.att_proj", din, g1)
        lin(f"{name}.att_projM", din, g1)
        for w in ("11", "22", "12", "M"):
            out[f"{name}.att_weight{w}"] = ((g1, 1), "att")
        lin(f"{name}.proj_with_att", din, g1)
        lin(f"{name}.proj_without_att", din, g1)
        lin(f"{name}.proj_with_attM", din, g1)
        lin(f"{name}.proj_without_attM", din, g1)
        bn(f"{name}.bn", g1)
    for name, d in (("pool_S", g0), ("pool_T", g0), ("pool_hS1", g1),
                    ("pool_hT1", g1), ("pool_hS2", g1), ("pool_hT2", g1)):
        lin(f"{name}.proj", d, 1)
    lin("out_layer", 5 * g1, 2)
    return out


# ------------------------------------------------------------- the layers
class _Net:
    """One forward's context: the parameters, the operand rounding, the
    dropout and the mode."""

    def __init__(self, P: Params, q: Callable, drop: Optional[Callable]):
        self.P, self.q, self.drop = P, q, drop
        self.train = drop is not None

    def conv(self, x, name, padding):
        b = self.P.get(f"{name}.bias")
        return F.conv2d(self.q(x), self.q(self.P[f"{name}.weight"]), b,
                        padding=padding)

    def lin(self, x, name):
        b = self.P.get(f"{name}.bias")
        return F.linear(self.q(x), self.q(self.P[f"{name}.weight"]), b)

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def bn(self, x, name, axis):
        P = self.P
        stats = ((None, None) if self.train else
                 (P[f"{name}.running_mean"], P[f"{name}.running_var"]))
        y = F.batch_norm(x.movedim(axis, 1), *stats, P[f"{name}.weight"],
                         P[f"{name}.bias"], training=self.train, eps=BN_EPS)
        return y.movedim(1, axis)

    def dropout(self, x, p):
        return x if self.drop is None else self.drop(x, p)

    # encoder blocks
    def residual(self, x, p, cin, cout):
        out = torch.selu(self.bn(self.conv(x, f"{p}.conv1", (1, 1)),
                                 f"{p}.bn2", 1))
        out = self.conv(out, f"{p}.conv2", (0, 1))
        ident = (self.conv(x, f"{p}.conv_downsample", (0, 1))
                 if cin != cout else x)
        return F.max_pool2d(out + ident, (1, 3))

    def res2net(self, x, p, cin, cout, first, width, scale):
        ident = x
        if not first:
            x = torch.selu(self.bn(x, f"{p}.bn1", 1))
        width = min(width, cin)
        scale = min(scale, width)
        outs, sp = [], None
        for i, spx in enumerate(torch.split(x, split_sizes(cin, width), 1)):
            sp = sp + spx if i > 0 and i % scale == 0 else spx
            sp = self.conv(sp, f"{p}.convs.{i}", (1, 1))
            outs.append(sp)
        out = torch.selu(self.bn(torch.cat(outs, 1), f"{p}.bn2", 1))
        out = self.conv(out, f"{p}.conv_cat", (1, 1))
        gate = torch.relu(self.lin(out.mean(dim=(2, 3)), f"{p}.se.fc.0"))
        gate = torch.sigmoid(self.lin(gate, f"{p}.se.fc.2"))
        out = out * gate[:, :, None, None]
        if cin != cout:
            ident = self.conv(ident, f"{p}.conv_downsample", (0, 1))
        return F.max_pool2d(out + ident, (1, 3))

    # graph layers
    def gat(self, x, name, temp):
        x = self.dropout(x, 0.2)
        pair = x[:, :, None, :] * x[:, None, :, :]
        a = self.mm(torch.tanh(self.lin(pair, f"{name}.att_proj")),
                    self.P[f"{name}.att_weight"])
        a = torch.softmax(a / temp, dim=-2)[..., 0]
        agg = self.mm(a, x)
        y = (self.lin(agg, f"{name}.proj_with_att")
             + self.lin(x, f"{name}.proj_without_att"))
        return torch.selu(self.bn(y, f"{name}.bn", -1))

    def htrg(self, x1, x2, master, name, temp):
        P = self.P
        n1 = x1.shape[1]
        x = torch.cat([self.lin(x1, f"{name}.proj_type1"),
                       self.lin(x2, f"{name}.proj_type2")], dim=1)
        x = self.dropout(x, 0.2)
        pair = x[:, :, None, :] * x[:, None, :, :]
        a = torch.tanh(self.lin(pair, f"{name}.att_proj"))
        s11 = self.mm(a, P[f"{name}.att_weight11"])
        s22 = self.mm(a, P[f"{name}.att_weight22"])
        s12 = self.mm(a, P[f"{name}.att_weight12"])
        att = torch.cat([torch.cat([s11[:, :n1, :n1], s12[:, :n1, n1:]], 2),
                         torch.cat([s12[:, n1:, :n1], s22[:, n1:, n1:]], 2)],
                        1)
        att = torch.softmax(att / temp, dim=-2)[..., 0]
        am = torch.tanh(self.lin(x * master, f"{name}.att_projM"))
        am = torch.softmax(self.mm(am, P[f"{name}.att_weightM"]) / temp,
                           dim=-2)
        m_agg = self.mm(am.transpose(1, 2), x)
        new_master = (self.lin(m_agg, f"{name}.proj_with_attM")
                      + self.lin(master, f"{name}.proj_without_attM"))
        y = (self.lin(self.mm(att, x), f"{name}.proj_with_att")
             + self.lin(x, f"{name}.proj_without_att"))
        y = torch.selu(self.bn(y, f"{name}.bn", -1))
        return y[:, :n1], y[:, n1:], new_master

    def pool(self, h, name, k):
        scores = torch.sigmoid(self.lin(self.dropout(h, 0.3),
                                        f"{name}.proj"))
        n_keep = max(int(h.shape[1] * k), 1)
        idx = torch.topk(scores[..., 0], n_keep, dim=1, sorted=True).indices
        h = h * scores
        return torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))


def forward(P: Params, x: torch.Tensor, mc, bank: torch.Tensor, *,
            q: Callable = _ident, drop: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) float32 waveforms -> (last_hidden (B, 5 g1), logits (B, 2)).
    ``bank`` is ``sinc_bank`` as a tensor on ``x``'s device."""
    net = _Net(P, q, drop)
    filts = mc["filts"]
    r = mc["pool_ratios"]
    t = mc["temperatures"]
    h = F.conv1d(q(x[:, None, :]), q(bank[:, None, :])).abs()[:, None]
    e = torch.selu(net.bn(F.max_pool2d(h, 3), "first_bn", 1))
    for i, (cin, cout) in enumerate(encoder_plan(filts)):
        if is_res2net(mc):
            e = net.res2net(e, f"encoder.{i}", cin, cout, i == 0,
                            mc.get("res2net_width", 14),
                            mc.get("res2net_scale", 8))
        else:
            e = net.residual(e, f"encoder.{i}", cin, cout)

    e_s = e.abs().amax(dim=3).transpose(1, 2) + P["pos_S"]
    out_s = net.pool(net.gat(e_s, "GAT_layer_S", t[0]), "pool_S", r[0])
    e_t = e.abs().amax(dim=2).transpose(1, 2)
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
    if net.train:
        t1, t2, s1, s2, m1, m2 = (net.dropout(v, 0.2)
                                  for v in (t1, t2, s1, s2, m1, m2))
    out_t, out_s, master = (torch.maximum(t1, t2), torch.maximum(s1, s2),
                            torch.maximum(m1, m2))
    hidden = torch.cat([out_t.abs().amax(dim=1), out_t.mean(dim=1),
                        out_s.abs().amax(dim=1), out_s.mean(dim=1),
                        master[:, 0]], dim=1)
    hidden = net.dropout(hidden, 0.5)
    return hidden, net.lin(hidden, "out_layer")


def crop_or_tile(x: np.ndarray, length: int) -> np.ndarray:
    """The published eval padding: the first ``length`` samples, the
    waveform repeated end to end where it is shorter."""
    if x.shape[0] >= length:
        return x[:length]
    return np.tile(x, length // x.shape[0] + 1)[:length]


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude onto e4m3's 448), back in ``t``'s type: the step below
    bfloat16 that a scoring cell's control takes."""
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def score_rows(P: Params, rows: np.ndarray, mc, *, device, block: int,
               q: Callable = _ident) -> np.ndarray:
    """Bonafide scores (logits[:, 1]) of (n, L) float32 rows, ``block``
    rows at a time, in float32 with TF32 off (restored after)."""
    bank = torch.from_numpy(sinc_bank(mc["filts"][0], mc["first_conv"])
                            ).to(device)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        with torch.inference_mode():
            for i in range(0, rows.shape[0], block):
                x = torch.from_numpy(rows[i:i + block]).to(device)
                out.append(forward(P, x, mc, bank, q=q)[1][:, 1].float()
                           .cpu().numpy())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    return np.concatenate(out) if out else np.zeros((0,), np.float32)

