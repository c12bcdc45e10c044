"""FLOPs an utterance of the plain reference, as the configurations store
them (``"flops": {"forward@<length>": ..., "train@<length>": ...}``):
``torch.utils.flop_counter.FlopCounterMode`` over one utterance, the
forward in eval mode, or the train-mode forward and the backward of the
weighted cross entropy into every parameter.  The counts are the model's
work; a program that skips or repeats work does not change them."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.lib import weights
from portbench.reference import aasist as ref
from portbench.reference import training as ref_train


def count(mc, length: int, train: bool) -> int:
    P = weights.make(ref, mc, 0, "cpu")
    bank = torch.from_numpy(ref.sinc_bank(mc["filts"][0], mc["first_conv"]))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, length)).astype(np.float32) * 0.1)
    counter = FlopCounterMode(display=False)
    if not train:
        with torch.no_grad(), counter:
            ref.forward(P, x, mc, bank)
        return counter.get_total_flops() // 2
    names = [n for n, (_, kind) in ref.param_shapes(mc).items()
             if kind not in ("bn_mean", "bn_var")]
    for n in names:
        P[n].requires_grad_(True)
    with counter:
        logits = ref.forward(P, x, mc, bank,
                             drop=ref_train.dropout_stream((1, 0, 0)))[1]
        loss = ref_train.weighted_cce(logits, torch.tensor([0, 1]))
        torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True)
    return counter.get_total_flops() // 2
