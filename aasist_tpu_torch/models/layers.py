"""Building blocks of the model zoo, in eval and train mode (counterpart of
``aasist_tpu/models/layers.py``).

Each module's parameter names are the JAX tree's keys, so
``weights.load_jax_params`` maps a checkpoint by name (the reference's
``nn.Sequential`` indices included: ``se.fc.0``, ``attention.2``).
Reference quirks the checkpoints were trained with are kept: the attention
softmax runs over the source-node axis (-2), both cross blocks of the
heterogeneous attention share ``att_weight12``, graph pooling keeps its
nodes in descending-score order, the residual block's ``bn1`` output is
discarded (in train mode bn1 still runs, so its running statistics move,
and its parameters get no gradient), and the Res2Net block's carry joins a
split only every ``scale`` splits.

In train mode (``module.train()``) BatchNorm uses the batch's statistics
and updates its running ones, and the graph layers apply the JAX package's
dropouts, drawn from the ``nn.RngStream`` passed to ``forward``: 0.2 on a
graph attention's input, the pool's ``dropout_p`` on the scores' input.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from aasist_tpu_torch import nn
from aasist_tpu_torch.utils.profiling import annotate


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


def freq_mask_rows(bank: torch.Tensor, width: int, start: int
                   ) -> torch.Tensor:
    """``bank`` with its rows [start, start + width) zeroed."""
    rows = torch.arange(bank.shape[0], device=bank.device)[:, None]
    keep = (rows < start) | (rows >= start + width)
    return torch.where(keep, bank, torch.zeros((), dtype=bank.dtype,
                                               device=bank.device))


def freq_mask_draw(generator: torch.Generator, channels: int
                   ) -> Tuple[int, int]:
    """The reference's frequency-mask law: width ``floor(U[0, 20))``, start
    uniform over 0 .. channels - width inclusive; two draws from a CPU
    ``generator`` (no device sync)."""
    width = int(torch.rand((), generator=generator,
                           dtype=torch.float64) * 20.0)
    start = int(torch.randint(0, channels + 1 - width, (),
                              generator=generator))
    return width, start


def freq_mask_filterbank(generator: torch.Generator, bank: torch.Tensor
                         ) -> torch.Tensor:
    """Frequency-band augmentation (``freq_aug``): zero a random contiguous
    run of filters, drawn by ``freq_mask_draw``."""
    return freq_mask_rows(bank, *freq_mask_draw(generator, bank.shape[0]))


def model_input(model: tnn.Module, x: torch.Tensor, rngs: nn.RngStream,
                freq_aug: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``x`` in the dtype of ``model``'s filterbank (the dtype it was cast
    to), contiguous; the filterbank, frequency-masked from the stream's
    next generator when ``freq_aug``).  The mask is drawn on the host."""
    bank = model.filterbank
    if freq_aug:
        g = rngs.next("cpu")
        if g is None:
            raise ValueError("freq_aug needs an RngStream with a key")
        bank = freq_mask_filterbank(g, bank)
    return x.to(bank.dtype).contiguous(), bank


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

    def forward(self, x: torch.Tensor, rngs: Optional[nn.RngStream] = None
                ) -> torch.Tensor:
        x = nn.stream_dropout(rngs, x, 0.2, self.training)
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
                master: Optional[torch.Tensor] = None,
                rngs: Optional[nn.RngStream] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n1 = x1.shape[1]
        x = torch.cat([self.proj_type1(x1), self.proj_type2(x2)], dim=1)
        if master is None:
            master = x.mean(dim=1, keepdim=True)
        x = nn.stream_dropout(rngs, x, 0.2, self.training)

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
    """Keep the top ``max(int(N*k), min_nodes)`` nodes, in descending-score
    order, each scaled by its sigmoid score (AASIST keeps at least 1 node,
    RawGAT-ST at least 2).  In train mode the scores are taken of the
    input after dropout ``dropout_p``; the kept features are not dropped."""

    def __init__(self, in_dim: int, k: float, min_nodes: int = 1,
                 dropout_p: float = 0.3):
        super().__init__()
        self.k = k
        self.min_nodes = min_nodes
        self.dropout_p = dropout_p
        self.proj = tnn.Linear(in_dim, 1)

    def forward(self, h: torch.Tensor, rngs: Optional[nn.RngStream] = None
                ) -> torch.Tensor:
        z = nn.stream_dropout(rngs, h, self.dropout_p, self.training)
        scores = torch.sigmoid(self.proj(z))                  # (B,N,1)
        n_keep = max(int(h.shape[1] * self.k), self.min_nodes)
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
    MaxPool (1,3), left out with ``pool=False`` (SSL-AASIST's blocks keep
    the map's size).

    ``bn1`` (absent in the first block) is kept so the checkpoints load and
    the parameter counts match: the reference computes bn1 + selu and then
    convolves the raw input.  So eval never uses it, and in train mode it
    runs on the input only to move its running statistics; its output is
    thrown away, so its weight and bias get no gradient (``.grad`` stays
    ``None``) and torch's optimizers skip them, as the reference's did.
    """

    def __init__(self, in_ch: int, out_ch: int, first: bool,
                 pool: bool = True):
        super().__init__()
        self.pool = pool
        self.conv1 = tnn.Conv2d(in_ch, out_ch, (2, 3), padding=(1, 1))
        self.conv2 = tnn.Conv2d(out_ch, out_ch, (2, 3), padding=(0, 1))
        self.bn2 = tnn.BatchNorm2d(out_ch)
        if not first:
            self.bn1 = tnn.BatchNorm2d(in_ch)
        self.conv_downsample = (
            tnn.Conv2d(in_ch, out_ch, (1, 3), padding=(0, 1))
            if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and hasattr(self, "bn1"):
            with torch.no_grad():       # output discarded, state is real
                nn.batch_norm(self.bn1, x, axis=1)
        out = nn.selu(nn.batch_norm(self.bn2, self.conv1(x), axis=1))
        out = self.conv2(out)
        identity = (x if self.conv_downsample is None
                    else self.conv_downsample(x))
        out = out + identity
        return nn.max_pool(out, (1, 3)) if self.pool else out


@contextlib.contextmanager
def _bn_state_kept(module: tnn.Module):
    """Restore ``module``'s BatchNorm buffers on exit: a recomputed forward
    must not move the running statistics a second time."""
    bufs = [b for m in module.modules()
            if isinstance(m, tnn.modules.batchnorm._BatchNorm)
            for b in m.buffers()]
    saved = [b.clone() for b in bufs]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(bufs, saved):
                b.copy_(v)


def _remat_block(block: tnn.Module, e: torch.Tensor) -> torch.Tensor:
    """``block(e)`` under ``torch.utils.checkpoint``, with the parameters
    and buffers the block holds now (a caller's ``functional_call`` may
    have swapped in bf16 copies) passed in, so the recompute in the
    backward uses them; the BatchNorm statistics it moves are put back.
    The buffers go in by closure: an input of the checkpoint must not be
    changed in place, and BatchNorm changes its statistics."""
    held = dict(block.named_parameters())
    names = list(held)
    buffers = dict(block.named_buffers())

    def run(e, *tensors):
        return torch.func.functional_call(
            block, {**buffers, **dict(zip(names, tensors))}, (e,))

    return checkpoint(run, e, *held.values(), use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _bn_state_kept(block)))


def run_encoder(blocks, e: torch.Tensor, remat: bool, first: int = 0
                ) -> torch.Tensor:
    """``e`` through ``blocks`` in turn.  With ``remat`` in a train-mode
    forward that records gradients, each block is rematerialised in the
    backward (``torch.utils.checkpoint``, the JAX package's
    ``jax.checkpoint``): the same math, the early blocks' large activations
    not kept; the recompute leaves the running statistics as the forward
    left them.  Each block's call is the span ``model.block<i>``
    (``utils/profiling.py:annotate``), ``i`` its index in the encoder
    (``first`` that of ``blocks[0]``); a recompute in the backward runs
    outside it."""
    for i, block in enumerate(blocks, first):
        with annotate(f"model.block{i}"):
            if remat and block.training and torch.is_grad_enabled():
                e = _remat_block(block, e)
            else:
                e = block(e)
    return e


def encoder_plan(filts) -> list:
    """The six encoder blocks' (in, out) channels: filts[1..4], the last
    repeated."""
    return [filts[1], filts[2], filts[3], filts[4], filts[4], filts[4]]


def residual_encoder(filts, pool: bool = True) -> tnn.ModuleList:
    return tnn.ModuleList(ResidualBlock(cin, cout, first=(i == 0), pool=pool)
                          for i, (cin, cout) in enumerate(encoder_plan(filts)))


# =====================================================================
# SE layer + Res2Net block (AASIST2's encoder)
# =====================================================================
class SE(tnn.Module):
    """Squeeze-and-excitation over NCHW: channel means -> fc -> ReLU -> fc
    -> sigmoid gates, no biases."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = tnn.Sequential(
            tnn.Linear(channels, channels // reduction, bias=False),
            tnn.ReLU(),
            tnn.Linear(channels // reduction, channels, bias=False),
            tnn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


def res2net_split_sizes(in_ch: int, width: int) -> list:
    """Channels of each split: ``width - 1`` of ``max(1, in_ch // width)``
    and the rest in the last (thirteen 2s and a 6 at 32 / 14)."""
    base = max(1, in_ch // width)
    return [base] * (width - 1) + [in_ch - base * (width - 1)]


class Res2NetBlock(tnn.Module):
    """Res2Net + SE encoder block: bn1 / SELU (consumed, unlike the
    residual block's) -> a (3,3) conv per channel split, split i starting
    from the previous split's output plus its own channels where
    ``i % scale == 0`` (i > 0) and afresh elsewhere -> concat -> bn2 / SELU
    -> (3,3) ``conv_cat`` -> SE -> + identity (a (1,3) conv when channels
    change) -> MaxPool (1,3).  Width and scale clamp to ``in_ch``: the first
    block (1 channel) has one split."""

    def __init__(self, in_ch: int, out_ch: int, first: bool,
                 width: int = 14, scale: int = 8):
        super().__init__()
        self.width = min(width, in_ch)
        self.scale = min(scale, self.width)
        self.sizes = res2net_split_sizes(in_ch, self.width)
        self.convs = tnn.ModuleList(tnn.Conv2d(c, c, 3, padding=1)
                                    for c in self.sizes)
        self.conv_cat = tnn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.se = SE(out_ch)
        self.bn2 = tnn.BatchNorm2d(in_ch)
        if not first:
            self.bn1 = tnn.BatchNorm2d(in_ch)
        self.conv_downsample = (
            tnn.Conv2d(in_ch, out_ch, (1, 3), padding=(0, 1))
            if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        if hasattr(self, "bn1"):
            x = nn.selu(nn.batch_norm(self.bn1, x, axis=1))
        outputs = []
        sp = None
        for i, spx in enumerate(torch.split(x, self.sizes, dim=1)):
            sp = sp + spx if i > 0 and i % self.scale == 0 else spx
            sp = self.convs[i](sp)
            outputs.append(sp)
        out = nn.selu(nn.batch_norm(self.bn2, torch.cat(outputs, dim=1),
                                    axis=1))
        out = self.se(self.conv_cat(out))
        if self.conv_downsample is not None:
            identity = self.conv_downsample(identity)
        return nn.max_pool(out + identity, (1, 3))


def res2net_encoder(filts, width: int, scale: int) -> tnn.ModuleList:
    return tnn.ModuleList(
        Res2NetBlock(cin, cout, first=(i == 0), width=width, scale=scale)
        for i, (cin, cout) in enumerate(encoder_plan(filts)))


# =====================================================================
# Speaker conditioning (AASIST2)
# =====================================================================
class SpeakerConditioning(tnn.Module):
    """Fuse a projected speaker embedding into features.

    ``level="frame"``: features (B, N, D); the embedding, projected to D
    and broadcast over the N nodes (weighted by a softmax over the nodes of
    an attention score when ``use_attention``), is concatenated to each
    node, then Linear -> ReLU.  ``level="utterance"``: features (B, D), or
    (B, N, D) averaged over the nodes, concatenated with the projected
    embedding, then Linear -> ReLU.
    """

    def __init__(self, spk_emb_dim: int, target_dim: int,
                 use_attention: bool = True, level: str = "frame"):
        super().__init__()
        if level not in ("frame", "utterance"):
            raise ValueError(f"conditioning_level {level!r}: frame or "
                             "utterance")
        self.level = level
        self.proj = tnn.Linear(spk_emb_dim, target_dim)
        self.fusion = tnn.Sequential(tnn.Linear(2 * target_dim, target_dim),
                                     tnn.ReLU())
        self.attention = (tnn.Sequential(
            tnn.Linear(2 * target_dim, target_dim), tnn.Tanh(),
            tnn.Linear(target_dim, 1)) if use_attention else None)

    def forward(self, features: torch.Tensor, spk_emb: torch.Tensor
                ) -> torch.Tensor:
        spk = self.proj(spk_emb)                              # (B, D)
        if self.level == "utterance":
            if features.dim() == 3:
                features = features.mean(dim=1)
            return self.fusion(torch.cat([features, spk], dim=1))
        spk = spk[:, None, :].expand(-1, features.shape[1], -1)
        if self.attention is not None:
            w = torch.softmax(self.attention(
                torch.cat([features, spk], dim=2)), dim=1)    # (B, N, 1)
            spk = w * spk
        return self.fusion(torch.cat([features, spk], dim=2))
