"""The train-step differential against the PyTorch reference's float64
goldens (``tests/goldens/train_diff_*.npz``, made by
``tools/make_train_golden.py``), run by the port on any device.

For AASIST, AASIST2, RawGAT-ST and RawNet2: per-leaf gradients of weighted
CCE, AM-Softmax and ALMFT (those a golden carries) through the model in
train mode with dropout off, the BatchNorm running statistics after that
forward, then the reference's optimizer protocol (lr, forward, loss,
gradients to ``None``, backward, ``Adam.step()``) for two steps under the
per-batch cosine schedule, each step's parameters and statistics; and the
lr trajectories of the four schedulers.  Gates: 1e-8 absolute on
gradients, parameters and statistics, 1e-12 on the lr, those of
``tools/check_train_differential.py``.  A leaf whose gradient is ``None``
(the discarded bn1) reads as zeros, as the golden stores it.

    python -m aasist_tpu_torch.tools.train_golden [--device cuda|cpu] \\
        [lr rawnet2 aasist aasist2 rawgatst]

It runs on the card (``--device`` defaults to ``cuda``; without a card
that raises, as the CLI does: pass ``--device cpu``).
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from aasist_tpu_torch.tools._common import ROOT

GOLDENS = ROOT / "tests" / "goldens"
GATE = 1e-8
LR_GATE = 1e-12

# the reference capture's settings (tools/make_train_golden.py)
AMS_SCALE = 15.0
AMS_MARGIN = 0.25
ALMFT_MA, ALMFT_MB = 0.06, 0.14
ADAM_OPTIM_CONFIG = {
    "optimizer": "adam", "amsgrad": "False", "base_lr": 0.0001,
    "lr_min": 0.000005, "betas": [0.9, 0.999], "weight_decay": 0.0001,
    "scheduler": "cosine", "epochs": 100, "steps_per_epoch": 7,
}
_AASIST = {
    "architecture": "AASIST", "first_conv": 128,
    "filts": [70, [1, 32], [32, 32], [32, 64], [64, 64]],
    "gat_dims": [64, 32], "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}
# name: (model config, where its weights are: "npz" file, or "sd:" golden
# of the reference state dict, loss of the Adam steps, model names)
MODELS = {
    "aasist": (_AASIST, "npz:checkpoints/AASIST.npz", "cce"),
    "rawnet2": ({
        "architecture": "RawNet2Spoof", "first_conv": 1024,
        "filts": [20, [20, 20], [20, 32], [32, 32]], "nb_fc_node": 24,
        "gru_node": 48, "nb_gru_layer": 3, "nb_classes": 2},
        "sd:train_diff_rawnet2.npz", "cce"),
    "aasist2": ({**_AASIST, "res2net_width": 14, "res2net_scale": 8,
                 "speaker_conditioning": True, "spk_emb_dim": 256,
                 "conditioning_level": "frame", "use_attention": True},
                "sd:aasist2_golden.npz", "almft"),
    "rawgatst": ({"architecture": "RawNetGatSpoofST", "first_conv": 128,
                  "filts": [70, [1, 32], [32, 32], [32, 64], [64, 64]]},
                 "sd:rawgatst_golden.npz", "cce"),
}
_SEQ_WRAPPER = re.compile(r"^(encoder(?:_[ST])?\.\d+|block\d+)\.0\.")


def tagged(data, tag: str) -> Dict[str, np.ndarray]:
    """A golden's ``{tag}__{reference key}`` arrays by the port's names."""
    pre = tag + "__"
    return {_SEQ_WRAPPER.sub(r"\1.", k[len(pre):]): data[k]
            for k in data.files if k.startswith(pre)}


def golden_model(name: str, device="cuda"
                 ) -> Tuple[torch.nn.Module, object]:
    """(the model in float64 on ``device`` with the golden's weights and
    filterbank, the golden's arrays).  A CUDA device without a card
    raises."""
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.utils.torch_compat import fill_from_state_dict
    from aasist_tpu_torch.weights import load_npz

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train_golden: no CUDA device is available; pass --device cpu "
            "(device=\"cpu\") to run on the CPU")
    conf, where, _ = MODELS[name]
    data = np.load(GOLDENS / f"train_diff_{name}.npz")
    model = build_model(conf).double()
    kind, path = where.split(":")
    if kind == "npz":
        load_npz(model, ROOT / path)
    else:
        sd = np.load(GOLDENS / path)
        fill_from_state_dict(model, {k[len("sd__"):]: sd[k]
                                     for k in sd.files
                                     if k.startswith("sd__")})
    model = model.to(device)
    model.filterbank = torch.from_numpy(data["band_pass"]).to(device)
    return model, data


def _losses(data, device) -> Dict[str, Callable]:
    from aasist_tpu_torch.train.losses import am_softmax, weighted_cce
    y1 = torch.from_numpy(data["y1"]).to(device)
    dur1 = torch.from_numpy(data["dur1"]).to(device)
    return {
        "cce": lambda lg: weighted_cce(lg, y1),
        "ams": lambda lg: am_softmax(lg, y1, scale=AMS_SCALE,
                                     margin=AMS_MARGIN),
        "almft": lambda lg: am_softmax(lg, y1, scale=AMS_SCALE,
                                       margin=AMS_MARGIN, durations=dur1,
                                       margin_a=ALMFT_MA, margin_b=ALMFT_MB),
    }


def _worst(model: torch.nn.Module, golden: Dict[str, np.ndarray],
           grads: bool) -> Tuple[float, str]:
    """max |port - golden| over the golden's leaves: each parameter's
    gradient (``grads``; ``None`` as zeros) or value, each buffer's value."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    worst, where = -1.0, "?"
    for key, want in golden.items():
        if key in params:
            t = params[key]
            if grads:
                t = t.grad if t.grad is not None else torch.zeros_like(t)
        else:
            t = buffers[key]
        d = float(np.max(np.abs(t.detach().cpu().numpy() - want)))
        if d > worst:
            worst, where = d, key
    return worst, where


def check_model(name: str, device="cuda") -> List[Tuple[str, float, str,
                                                         float]]:
    """The readings of one model's golden: (label, max |diff|, worst leaf,
    gate) for each loss's value, gradients and statistics, and each Adam
    step's loss, parameters and statistics."""
    from aasist_tpu_torch import nn
    from aasist_tpu_torch.config import OptimConfig
    from aasist_tpu_torch.train.optim import create_optimizer, make_schedule

    model, data = golden_model(name, device)
    pristine = {k: v.clone() for k, v in model.state_dict().items()}
    spk = (torch.from_numpy(data["spk"]).to(device)
           if "spk" in data.files else None)

    def forward(x):
        kw = {} if spk is None else {"speaker_embedding": spk}
        return model(x, rngs=nn.RngStream(None, dropout_enabled=False),
                     **kw)[1]

    def batch(key):
        return torch.from_numpy(data[key]).to(device)

    out = []
    model.train()
    losses = _losses(data, device)
    for lname in losses:
        if f"loss_{lname}" not in data.files:
            continue
        model.load_state_dict(pristine)
        model.zero_grad(set_to_none=True)
        loss = losses[lname](forward(batch("x1")))
        loss.backward()
        golden = tagged(data, f"grad{lname}")
        out.append((f"{name} loss_{lname}",
                    abs(loss.item() - float(data[f"loss_{lname}"])), "",
                    GATE))
        out.append((f"{name} grads_{lname}", *_worst(model, golden, True),
                    GATE))
        out.append((f"{name} bnstats_{lname}", *_worst(model, {
            k: v for k, v in golden.items() if "running_" in k}, False),
            GATE))

    model.load_state_dict(pristine)
    cfg = OptimConfig.from_dict(ADAM_OPTIM_CONFIG)
    optimizer = create_optimizer(cfg, model.parameters())
    schedule = make_schedule(cfg)
    from aasist_tpu_torch.train.losses import am_softmax, weighted_cce
    for i, (xk, yk, dk) in enumerate((("x1", "y1", "dur1"),
                                      ("x2", "y2", "dur2")), start=1):
        for group in optimizer.param_groups:
            group["lr"] = schedule(i - 1)
        logits = forward(batch(xk))
        if MODELS[name][2] == "almft":
            loss = am_softmax(logits, batch(yk), scale=AMS_SCALE,
                              margin=AMS_MARGIN, durations=batch(dk),
                              margin_a=ALMFT_MA, margin_b=ALMFT_MB)
        else:
            loss = weighted_cce(logits, batch(yk))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        golden = tagged(data, f"adam{i}")
        out.append((f"{name} adam_loss{i}",
                    abs(loss.item() - float(data["adam_losses"][i - 1])),
                    "", GATE))
        out.append((f"{name} adam_lr{i}",
                    abs(schedule(i - 1) - float(data["adam_lrs"][i - 1])),
                    "", LR_GATE))
        out.append((f"{name} adam_state{i}", *_worst(model, golden, False),
                    GATE))
    return out


def check_lr() -> List[Tuple[str, float, str, float]]:
    """The four schedules against the reference's trajectories: cosine and
    keras decay step by step, multistep and SGDR epoch by epoch, read at
    three steps of each epoch."""
    from aasist_tpu_torch.config import OptimConfig
    from aasist_tpu_torch.train.optim import make_schedule

    data = np.load(GOLDENS / "train_diff_lr.npz")
    spe = 7
    out = []
    for name in ("cosine", "keras_decay"):
        sched = make_schedule(OptimConfig.from_dict({
            "scheduler": name, "base_lr": 1e-4, "lr_min": 5e-6,
            "epochs": 100, "steps_per_epoch": spe}))
        gold = data[f"lr_{name}"]
        out.append((f"lr {name}", max(abs(sched(i) - g)
                                      for i, g in enumerate(gold)), "",
                    LR_GATE))
    for name, extra in (("multistep", {"milestones": [10, 20, 30],
                                       "lr_decay": 0.5}),
                        ("sgdr", {"T0": 5, "Tmult": 2, "lr_min": 1e-6})):
        sched = make_schedule(OptimConfig.from_dict({
            "scheduler": name, "base_lr": 1e-4, "epochs": 40,
            "steps_per_epoch": spe, **extra}))
        gold = data[f"lr_{name}"]
        out.append((f"lr {name}", max(
            abs(sched(e * spe + b) - g) for e, g in enumerate(gold)
            for b in (0, spe // 2, spe - 1)), "", LR_GATE))
    return out


def run(names, device="cuda", printout=True
        ) -> List[Tuple[str, float, str, float]]:
    readings = []
    for name in names:
        readings += check_lr() if name == "lr" else check_model(name, device)
    if printout:
        for label, d, where, gate in readings:
            print(f"{'ok ' if d <= gate else 'FAIL'} {label}: "
                  f"max|diff|={d:.3e} (gate {gate:g}) {where}")
    return readings


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("names", nargs="*",
                    default=["lr", "rawnet2", "aasist", "aasist2",
                             "rawgatst"])
    args = ap.parse_args(argv)
    readings = run(args.names, args.device)
    return int(any(d > gate for _, d, _, gate in readings))


if __name__ == "__main__":
    sys.exit(main())
