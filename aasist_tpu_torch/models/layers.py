"""AASIST building blocks, eval mode (counterpart of
``aasist_tpu/models/layers.py``).

Each module's parameter names are the JAX tree's keys, so
``weights.load_jax_params`` maps a checkpoint by name.  Reference quirks the
checkpoints were trained with are kept: the attention softmax runs over the
source-node axis (-2), both cross blocks of the heterogeneous attention
share ``att_weight12``, graph pooling keeps its nodes in descending-score
order, and the residual block's ``bn1`` output is discarded.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from aasist_tpu_torch import nn


# =====================================================================
# Sinc filterbank frontend
# =====================================================================
def mel_from_hz(hz):
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def hz_from_mel(mel):
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def sinc_filterbank(out_channels: int, kernel_size: int,
                    sample_rate: int = 16000) -> np.ndarray:
    """Fixed mel-spaced band-pass filterbank, (out_channels, kernel_size).

    Built in float64 and cast to float32, like the reference; an even
    ``kernel_size`` grows by one tap (128 -> 129).
    """
    if kernel_size % 2 == 0:
        kernel_size += 1
    nfft = 512
    f = int(sample_rate / 2) * np.linspace(0, 1, nfft // 2 + 1)
    fmel = mel_from_hz(f)
    mel_edges = np.linspace(fmel.min(), fmel.max(), out_channels + 1)
    hz_edges = hz_from_mel(mel_edges)
    hsupp = np.arange(-(kernel_size - 1) / 2, (kernel_size - 1) / 2 + 1)
    ham = np.hamming(kernel_size)
    bank = np.zeros((out_channels, kernel_size))
    for i in range(out_channels):
        fmin, fmax = hz_edges[i], hz_edges[i + 1]
        h_high = (2 * fmax / sample_rate) * np.sinc(
            2 * fmax * hsupp / sample_rate)
        h_low = (2 * fmin / sample_rate) * np.sinc(
            2 * fmin * hsupp / sample_rate)
        bank[i] = ham * (h_high - h_low)
    return bank.astype(np.float32)


def sinc_frontend(bank: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The filterbank as a 1-D conv: (B, L) -> (B, C, L - K + 1)."""
    return F.conv1d(x[:, None, :], bank[:, None, :])


# =====================================================================
# Graph attention
# =====================================================================
def _att_weight(out_dim: int) -> tnn.Parameter:
    # xavier-normal (out_dim, 1), as gat_init; overwritten by the checkpoint
    std = math.sqrt(2.0 / (out_dim + 1))
    return tnn.Parameter(torch.randn(out_dim, 1) * std)


class GraphAttention(tnn.Module):
    """GraphAttentionLayer: (B, N, D_in) -> (B, N, D_out)."""

    def __init__(self, in_dim: int, out_dim: int, temperature: float):
        super().__init__()
        self.temperature = temperature
        self.att_proj = tnn.Linear(in_dim, out_dim)
        self.att_weight = _att_weight(out_dim)
        self.proj_with_att = tnn.Linear(in_dim, out_dim)
        self.proj_without_att = tnn.Linear(in_dim, out_dim)
        self.bn = tnn.BatchNorm1d(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pair = x[:, :, None, :] * x[:, None, :, :]            # (B,N,N,D)
        a = torch.tanh(self.att_proj(pair)) @ self.att_weight  # (B,N,N,1)
        a = torch.softmax(a / self.temperature, dim=-2)       # source axis
        agg = torch.einsum("bij,bjd->bid", a[..., 0], x)
        y = self.proj_with_att(agg) + self.proj_without_att(x)
        return nn.selu(nn.batch_norm(self.bn, y, axis=-1))


class HtrgGraphAttention(tnn.Module):
    """Heterogeneous graph attention over two node types plus a master
    node: (x1, x2, master) -> (x1', x2', master')."""

    def __init__(self, in_dim: int, out_dim: int, temperature: float):
        super().__init__()
        self.temperature = temperature
        self.proj_type1 = tnn.Linear(in_dim, in_dim)
        self.proj_type2 = tnn.Linear(in_dim, in_dim)
        self.att_proj = tnn.Linear(in_dim, out_dim)
        self.att_projM = tnn.Linear(in_dim, out_dim)
        self.att_weight11 = _att_weight(out_dim)
        self.att_weight22 = _att_weight(out_dim)
        self.att_weight12 = _att_weight(out_dim)
        self.att_weightM = _att_weight(out_dim)
        self.proj_with_att = tnn.Linear(in_dim, out_dim)
        self.proj_without_att = tnn.Linear(in_dim, out_dim)
        self.proj_with_attM = tnn.Linear(in_dim, out_dim)
        self.proj_without_attM = tnn.Linear(in_dim, out_dim)
        self.bn = tnn.BatchNorm1d(out_dim)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                master: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n1 = x1.shape[1]
        x = torch.cat([self.proj_type1(x1), self.proj_type2(x2)], dim=1)
        if master is None:
            master = x.mean(dim=1, keepdim=True)

        # blockwise attention board; both cross blocks use att_weight12
        pair = x[:, :, None, :] * x[:, None, :, :]
        a = torch.tanh(self.att_proj(pair))                   # (B,N,N,Do)
        s11 = a @ self.att_weight11
        s22 = a @ self.att_weight22
        s12 = a @ self.att_weight12
        top = torch.cat([s11[:, :n1, :n1], s12[:, :n1, n1:]], dim=2)
        bot = torch.cat([s12[:, n1:, :n1], s22[:, n1:, n1:]], dim=2)
        att = torch.cat([top, bot], dim=1) / self.temperature
        att = torch.softmax(att, dim=-2)

        # master update: directional edges into the master node
        am = torch.tanh(self.att_projM(x * master))           # (B,N,Do)
        am = torch.softmax((am @ self.att_weightM) / self.temperature,
                           dim=-2)                            # (B,N,1)
        m_agg = torch.einsum("bn,bnd->bd", am[..., 0], x)[:, None, :]
        new_master = (self.proj_with_attM(m_agg)
                      + self.proj_without_attM(master))

        agg = torch.einsum("bij,bjd->bid", att[..., 0], x)
        y = self.proj_with_att(agg) + self.proj_without_att(x)
        y = nn.selu(nn.batch_norm(self.bn, y, axis=-1))
        return y[:, :n1], y[:, n1:], new_master


class GraphPool(tnn.Module):
    """Keep the top ``max(int(N*k), 1)`` nodes, in descending-score order,
    each scaled by its sigmoid score."""

    def __init__(self, in_dim: int, k: float):
        super().__init__()
        self.k = k
        self.proj = tnn.Linear(in_dim, 1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        scores = torch.sigmoid(self.proj(h))                  # (B,N,1)
        n_keep = max(int(h.shape[1] * self.k), 1)
        idx = torch.topk(scores[..., 0], n_keep, dim=1, sorted=True).indices
        h = h * scores
        return torch.gather(
            h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))


# =====================================================================
# Residual encoder block (the geometry the checkpoints were trained with)
# =====================================================================
class ResidualBlock(tnn.Module):
    """conv1 (2,3) pad (1,1) -> bn2 / selu -> conv2 (2,3) pad (0,1);
    a (1,3) downsample conv on the identity when channels change;
    MaxPool (1,3).

    ``bn1`` (absent in the first block) is kept so the checkpoints load and
    the parameter counts match, but eval never uses it: the reference
    computes bn1 + selu and then convolves the raw input.
    """

    def __init__(self, in_ch: int, out_ch: int, first: bool):
        super().__init__()
        self.conv1 = tnn.Conv2d(in_ch, out_ch, (2, 3), padding=(1, 1))
        self.conv2 = tnn.Conv2d(out_ch, out_ch, (2, 3), padding=(0, 1))
        self.bn2 = tnn.BatchNorm2d(out_ch)
        if not first:
            self.bn1 = tnn.BatchNorm2d(in_ch)
        self.conv_downsample = (
            tnn.Conv2d(in_ch, out_ch, (1, 3), padding=(0, 1))
            if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = nn.selu(nn.batch_norm(self.bn2, self.conv1(x), axis=1))
        out = self.conv2(out)
        identity = (x if self.conv_downsample is None
                    else self.conv_downsample(x))
        return nn.max_pool(out + identity, (1, 3))
