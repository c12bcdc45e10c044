"""Training losses (counterpart of ``aasist_tpu/train/losses.py``).

  * weighted cross entropy, class weights (0.1, 0.9) for (spoof, bonafide),
    the reference's, with optional label smoothing;
  * AM-Softmax with a fixed margin, or ALMFT's duration-adaptive margin
    ``margin_a * duration + margin_b``.

Each takes logits (B, K) and integer labels (B,) and returns the scalar
loss in the logits' dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

CCE_CLASS_WEIGHTS = (0.1, 0.9)  # (spoof, bonafide)


def weighted_cce(logits: torch.Tensor, labels: torch.Tensor,
                 weights=CCE_CLASS_WEIGHTS,
                 label_smoothing: float = 0.0) -> torch.Tensor:
    """Class-weighted cross entropy with the semantics of torch's
    ``CrossEntropyLoss(weight=w)``: sum(w_i * nll_i) / sum(w_i), w_i the
    weight of row i's class.  With ``label_smoothing`` s the target is
    (1 - s) * onehot + s / K, still weighted by the row's class (the JAX
    package's rule; torch's own smoothing weights each class's term)."""
    logp = F.log_softmax(logits, dim=-1)
    if label_smoothing > 0.0:
        k = logits.shape[-1]
        target = ((1.0 - label_smoothing)
                  * F.one_hot(labels, k).to(logits.dtype)
                  + label_smoothing / k)
        nll = -(target * logp).sum(dim=-1)
    else:
        nll = -logp.gather(1, labels[:, None])[:, 0]
    w = torch.tensor(weights, dtype=logits.dtype,
                     device=logits.device)[labels]
    return (w * nll).sum() / w.sum().clamp_min(1e-12)


def am_softmax(logits: torch.Tensor, labels: torch.Tensor, *,
               scale: float = 15.0, margin: float = 0.2,
               durations: Optional[torch.Tensor] = None,
               margin_a: float = 3 / 50, margin_b: float = 7 / 50
               ) -> torch.Tensor:
    """AM-Softmax: the target class's logit less a margin, times ``scale``,
    then the mean cross entropy.  With ``durations`` (B,) in seconds the
    margin is ``margin_a * duration + margin_b`` (ALMFT), else ``margin``."""
    if durations is not None:
        m = margin_a * durations.to(logits.dtype) + margin_b
    else:
        m = torch.full(labels.shape, margin, dtype=logits.dtype,
                       device=logits.device)
    one_hot = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
    logp = F.log_softmax((logits - one_hot * m[:, None]) * scale, dim=-1)
    return -logp.gather(1, labels[:, None])[:, 0].mean()


LossFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                  torch.Tensor]


def make_loss_fn(loss_name: str, cfg) -> Tuple[LossFn, bool]:
    """(loss(logits, labels, durations), whether it reads the durations)
    for the config's ``loss``: ``CCE`` (with ``label_smoothing`` from the
    extras) or ``AM_Softmax`` (adaptive when ``adaptive_margin``)."""
    if loss_name == "CCE":
        smoothing = float(cfg.extras.get("label_smoothing", 0.0))

        def cce(logits, labels, durations=None):
            return weighted_cce(logits, labels, label_smoothing=smoothing)
        return cce, False
    if loss_name == "AM_Softmax":
        adaptive = bool(cfg.adaptive_margin)

        def ams(logits, labels, durations=None):
            return am_softmax(logits, labels, scale=cfg.am_softmax_scale,
                              margin=cfg.margin,
                              durations=durations if adaptive else None,
                              margin_a=cfg.margin_a, margin_b=cfg.margin_b)
        return ams, adaptive
    raise ValueError(f"Unknown loss type: {loss_name}")
