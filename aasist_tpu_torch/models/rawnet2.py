"""RawNet2 forward, eval and train (counterpart of
``aasist_tpu/models/rawnet2.py``).

A 1-D sinc frontend (20 filters x 1,025 taps) -> |.| -> maxpool 3 -> BN ->
SELU, (B, 20, 21192) at 64,600 samples; six 1-D residual blocks, each
followed by FMS attention (``hb * y + y``, y the sigmoid gate of the
block's channel means) -> (B, 128, 29); ``bn_before_gru`` -> SELU; a
3-layer GRU(1024) over the 29 frames, its last step -> ``fc1_gru``
(last_hidden) -> ``fc2_gru`` -> log-softmax.  The forward returns
``(last_hidden, log-probabilities)``; the score is the bonafide
log-probability.

Reference quirks kept: each block convolves its raw input, so eval never
uses ``bn1`` and train mode runs it only to move its running statistics
(its parameters get no gradient); block 2's config entry is mutated in
place, so blocks 3-5 are 128 -> 128.  Train mode: batch-statistics
BatchNorm, ``freq_aug``; the model has no dropout.  The GRU is ``torch.nn.GRU`` (cuDNN on a card), whose
parameter names (``gru.weight_ih_l0`` ...) are the JAX tree's.  The model
has no fused-frontend path: the JAX package computes this sinc conv outside
any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from aasist_tpu_torch import nn
from aasist_tpu_torch.models import layers as L


class ResidualBlock1d(tnn.Module):
    """conv1 (3) pad 1 -> bn2 -> leaky ReLU (0.3) -> conv2 (3) pad 1;
    a 1x1 downsample conv on the identity when channels change; MaxPool 3.
    ``bn1`` (absent in the first block) is kept for the checkpoints; in
    train mode it runs on the input for its statistics, output discarded."""

    def __init__(self, in_ch: int, out_ch: int, first: bool):
        super().__init__()
        self.conv1 = tnn.Conv1d(in_ch, out_ch, 3, padding=1)
        self.conv2 = tnn.Conv1d(out_ch, out_ch, 3, padding=1)
        self.bn2 = tnn.BatchNorm1d(out_ch)
        if not first:
            self.bn1 = tnn.BatchNorm1d(in_ch)
        self.conv_downsample = (tnn.Conv1d(in_ch, out_ch, 1)
                                if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and hasattr(self, "bn1"):
            with torch.no_grad():       # output discarded, state is real
                nn.batch_norm(self.bn1, x, axis=1)
        out = F.leaky_relu(nn.batch_norm(self.bn2, self.conv1(x), axis=1),
                           0.3)
        out = self.conv2(out)
        identity = (x if self.conv_downsample is None
                    else self.conv_downsample(x))
        return nn.max_pool(out + identity, (3,))


class RawNet2Model(tnn.Module):
    """RawNet2."""

    def __init__(self, model_config: Dict[str, Any]):
        super().__init__()
        for key in ("use_fused_frontend", "use_fused_stack"):
            if model_config.get(key):
                raise ValueError(f"{key}: RawNet2 has no such kernel path")
        self.config = dict(model_config)
        filts = model_config["filts"]
        plan = [(filts[1][0], filts[1][1]), (filts[1][1], filts[1][1]),
                (filts[2][0], filts[2][1])] + [(filts[2][1], filts[2][1])] * 3
        self.register_buffer("filterbank", torch.from_numpy(
            L.sinc_filterbank(filts[0], model_config["first_conv"])),
            persistent=False)
        self.first_bn = tnn.BatchNorm1d(filts[0])
        for i, (cin, cout) in enumerate(plan):
            setattr(self, f"block{i}", ResidualBlock1d(cin, cout, i == 0))
            setattr(self, f"fc_attention{i}",
                    tnn.Sequential(tnn.Linear(cout, cout)))
        self.n_blocks = len(plan)
        self.bn_before_gru = tnn.BatchNorm1d(plan[-1][1])
        self.gru = tnn.GRU(plan[-1][1], model_config["gru_node"],
                           num_layers=model_config["nb_gru_layer"],
                           batch_first=True)
        self.fc1_gru = tnn.Linear(model_config["gru_node"],
                                  model_config["nb_fc_node"])
        self.fc2_gru = tnn.Linear(model_config["nb_fc_node"],
                                  model_config["nb_classes"])
        self.eval()

    def forward(self, x: torch.Tensor, *,
                rngs: Optional[nn.RngStream] = None, freq_aug: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) waveform -> (last_hidden (B, nb_fc_node),
        log-probabilities (B, nb_classes))."""
        x, bank = L.model_input(self, x, rngs, freq_aug)
        h = nn.max_pool(L.sinc_frontend(bank, x).abs(), (3,))
        h = nn.selu(nn.batch_norm(self.first_bn, h, axis=1))
        for i in range(self.n_blocks):
            hb = getattr(self, f"block{i}")(h)
            y = torch.sigmoid(getattr(self, f"fc_attention{i}")(
                hb.mean(dim=2)))[:, :, None]                  # (B, C, 1)
            h = hb * y + y
        h = nn.selu(nn.batch_norm(self.bn_before_gru, h, axis=1))
        out, _ = self.gru(h.transpose(1, 2))                  # (B, T, H)
        last_hidden = self.fc1_gru(out[:, -1])
        return last_hidden, F.log_softmax(self.fc2_gru(last_hidden), dim=1)
