"""RawGAT-ST forward, eval and train (counterpart of
``aasist_tpu/models/rawgat_st.py``).

The sinc frontend (AASIST's: 70 x 129, |.|, maxpool (3,3), BN, SELU) feeds
TWO residual encoders.  Each view: max|e| -> GAT (temperature 1) -> graph
pool (at least 2 nodes) -> a Linear over the node axis to 12 nodes; the
views are fused by an element-wise product (B, 32, 12) -> GAT (32 -> 16) ->
pool to 7 nodes -> ``proj_ST`` to one value a node (B, 7) -> ``out_layer``
-> 2 logits.  The forward returns ``(proj_ST output, logits)``.

The reference's naming of the views is kept, swapped against AASIST's:
"T" is max over TIME (spectral nodes, 23 -> 14 kept), "S" max over
FREQUENCY (temporal nodes, 29 -> 23 kept).  ``proj_T`` (14 -> 12) and
``proj_S`` (23 -> 12) fix those node counts, so the model takes 64,600
samples with ``filts[0]`` 70, whatever its channel widths.  Train mode:
batch-statistics BatchNorm in both encoders and the graph layers, the
graph layers' dropouts and ``freq_aug``, as AASIST's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from aasist_tpu_torch import nn
from aasist_tpu_torch.models import layers as L
from aasist_tpu_torch.models.aasist import SincFrontendModel


class RawGatStModel(SincFrontendModel):
    """RawGAT-ST; ``use_fused_frontend`` as AASIST's."""

    def __init__(self, model_config: Dict[str, Any]):
        super().__init__(model_config)
        if model_config.get("use_fused_stack"):
            raise ValueError("use_fused_stack: RawGAT-ST has no fused "
                             "frontend + block-0 path")
        filts = model_config["filts"]
        d = filts[-1][-1]
        self.encoder_T = L.residual_encoder(filts)
        self.encoder_S = L.residual_encoder(filts)
        self.GAT_layer_T = L.GraphAttention(d, 32, 1.0)
        self.GAT_layer_S = L.GraphAttention(d, 32, 1.0)
        self.GAT_layer_ST = L.GraphAttention(32, 16, 1.0)
        self.pool_T = L.GraphPool(32, 0.64, min_nodes=2)
        self.pool_S = L.GraphPool(32, 0.81, min_nodes=2)
        self.pool_ST = L.GraphPool(16, 0.64, min_nodes=2)
        self.proj_T = tnn.Linear(14, 12)
        self.proj_S = tnn.Linear(23, 12)
        self.proj_ST = tnn.Linear(16, 1)
        self.out_layer = tnn.Linear(7, 2)
        self.eval()

    def forward(self, x: torch.Tensor, *,
                rngs: Optional[nn.RngStream] = None, freq_aug: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 64600) waveform -> (proj_ST output (B, 7), logits (B, 2))."""
        x, bank = L.model_input(self, x, rngs, freq_aug)
        e_t = e_s = self.frontend(x, bank)
        for block_t, block_s in zip(self.encoder_T, self.encoder_S):
            e_t, e_s = block_t(e_t), block_s(e_s)
        # "T": max over time -> spectral nodes (B, F, C)
        pool_t = self.pool_T(self.GAT_layer_T(
            e_t.abs().amax(dim=3).transpose(1, 2), rngs), rngs)  # (B,14,32)
        out_t = self.proj_T(pool_t.transpose(1, 2))            # (B,32,12)
        # "S": max over frequency -> temporal nodes (B, T, C)
        pool_s = self.pool_S(self.GAT_layer_S(
            e_s.abs().amax(dim=2).transpose(1, 2), rngs), rngs)  # (B,23,32)
        if pool_s.shape[1] != self.proj_S.in_features:
            raise ValueError(
                f"RawGAT-ST takes {self.config.get('nb_samp', 64600)}-sample "
                f"inputs: proj_S reads {self.proj_S.in_features} temporal "
                f"nodes, this input leaves {pool_s.shape[1]} (to train, "
                "set the config's train_fixed_length to 64600)")
        out_s = self.proj_S(pool_s.transpose(1, 2))            # (B,32,12)
        st = self.GAT_layer_ST((out_t * out_s).transpose(1, 2), rngs)
        proj_st = self.proj_ST(self.pool_ST(st, rngs))[..., 0]  # (B, 7)
        return proj_st, self.out_layer(proj_st)
