"""Plain PyTorch reference of the AASIST training step: the published
recipe, written from its description and independent of the program.

  * the batches: a per-epoch shuffle (numpy ``default_rng((seed,
    epoch))``), drop-last batches, each row cropped at a start drawn from
    [0, n - crop) by its own ``default_rng((seed, epoch, batch, row))``,
    or tiled when shorter, from 16-bit PCM scaled by 1 / 32768;
  * the forward in train mode (the model's module, ``aasist.py``):
    BatchNorm on the batch's statistics, and the published dropouts (0.2
    on each graph attention's input, 0.3 on each pool's scores, 0.2 on
    both branches' nodes and masters, 0.5 on the hidden vector), each
    mask drawn on the device by a generator seeded from (seed + 1, step,
    0, k) through numpy's ``SeedSequence``, k counting the step's draws;
  * class-weighted cross entropy, weights (0.1, 0.9) for (spoof,
    bonafide);
  * Adam with L2 weight decay added to the gradient, bias-corrected, and
    the cosine learning rate of the step (epochs x steps per epoch).

``follow`` runs the first three steps from given weights and returns what
the output check compares: each step's loss, the first step's gradient as
the optimizer takes it (weight decay included), the raw first gradient,
and each parameter's change after two steps (``delta``) and after three
(``delta3``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CLASS_WEIGHTS = (0.1, 0.9)


def crop_random(x: np.ndarray, length: int,
                rng: np.random.Generator) -> np.ndarray:
    n = x.shape[0]
    if n > length:
        start = rng.integers(0, n - length)
        return x[start:start + length]
    if n == length:
        return x
    return np.tile(x, length // n + 1)[:length]


def batches(pcm: Sequence[np.ndarray], ids: Sequence[str], labels,
            seed: int, batch: int, crop: int, n: int, epoch: int = 0
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The first ``n`` (x (batch, crop) float32, y (batch,)) of an
    epoch."""
    order = np.random.default_rng((seed, epoch)).permutation(len(ids))
    for b in range(n):
        idx = order[b * batch:(b + 1) * batch]
        rows = [crop_random(pcm[i].astype(np.float64) / 32768.0, crop,
                            np.random.default_rng((seed, epoch, b, j)))
                for j, i in enumerate(idx)]
        yield (np.stack(rows).astype(np.float32),
               np.array([labels[ids[i]] for i in idx], np.int64))


def generator(key: Sequence[int], device) -> torch.Generator:
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return g


def dropout_stream(key: Tuple[int, ...]):
    """``drop(x, p)`` for one step's forward: the k-th call draws its keep
    mask from ``generator(key + (k,))``."""
    count = [0]

    def drop(x: torch.Tensor, p: float) -> torch.Tensor:
        count[0] += 1
        keep = torch.empty(x.shape, dtype=x.dtype, device=x.device
                           ).bernoulli_(1.0 - p, generator=generator(
                               key + (count[0],), x.device))
        return x * keep / (1.0 - p)

    return drop


def weighted_cce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(CLASS_WEIGHTS, dtype=logits.dtype,
                     device=logits.device)[y]
    nll = -F.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]
    return (w * nll).sum() / w.sum()


def cosine_lr(optim: Dict, step: int, total: int) -> float:
    base, lo = optim["base_lr"], optim["lr_min"] / optim["base_lr"]
    return base * (lo + (1 - lo) * 0.5 * (1 + math.cos(step / total
                                                        * math.pi)))


@contextlib.contextmanager
def backends(tf32_on: bool, cudnn_benchmark: bool):
    """TF32 and cuDNN's timed algorithm choice as given, restored after."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = tf32_on
    b.cudnn.benchmark = cudnn_benchmark
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
         b.cudnn.benchmark) = saved


def follow(ref, P0: Dict[str, torch.Tensor],
           data: List[Tuple[np.ndarray, np.ndarray]], mc, train: Dict,
           seed: int, steps_per_epoch: int, device, *,
           tf32_on: bool = False, half_batch: bool = False,
           cudnn_benchmark: bool = False) -> Dict:
    """The first three steps (``data``) of the reference model ``ref`` (a
    module of ``portbench/reference/``) from weights ``P0``.  ``tf32_on``
    computes with TF32 (the control); ``half_batch`` leaves the second
    half of each batch out of the loss (a planted fault);
    ``cudnn_benchmark`` lets cuDNN pick its algorithms by timing, so the
    same f32 math rounds otherwise (a witness of round-off alone)."""
    optim = train["optim_config"]
    b1, b2 = optim["betas"]
    wd, eps = optim["weight_decay"], 1e-8
    total = max(1, train["num_epochs"] * steps_per_epoch)
    names = [n for n, (_, kind) in ref.param_shapes(mc).items()
             if kind not in ("bn_mean", "bn_var")]
    P = {k: v.detach().clone().to(device) for k, v in P0.items()}
    for n in names:
        P[n].requires_grad_(True)
    bank = torch.from_numpy(ref.sinc_bank(mc["filts"][0], mc["first_conv"])
                            ).to(device)
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    losses, grad1, raw1, delta = [], {}, {}, None
    with backends(tf32_on, cudnn_benchmark):
        for step, (x, y) in enumerate(data):
            x = torch.from_numpy(x).to(device)
            y = torch.from_numpy(y).to(device)
            logits = ref.forward(P, x, mc, bank,
                                 drop=dropout_stream((seed + 1, step, 0)))[1]
            if half_batch:
                h = x.shape[0] // 2
                logits, y = logits[:h], y[:h]
            loss = weighted_cce(logits, y)
            grads = torch.autograd.grad(loss, [P[n] for n in names],
                                        allow_unused=True)
            losses.append(float(loss.detach()))
            lr = cosine_lr(optim, step, total)
            t = step + 1
            with torch.no_grad():
                for n, g in zip(names, grads):
                    if g is None:       # never reaches the loss (bn1)
                        if step == 0:
                            raw1[n] = torch.zeros_like(P[n])
                        continue
                    if step == 0:
                        raw1[n] = g.clone()
                    g = g + wd * P[n]
                    if step == 0:
                        grad1[n] = g.clone()
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n] / (1 - b2 ** t)).sqrt_().add_(eps)
                    P[n].sub_(lr / (1 - b1 ** t) * m[n] / denom)
            if step == 1:
                delta = {n: P[n].detach() - P0[n].to(device) for n in names}
    delta3 = {n: P[n].detach() - P0[n].to(device) for n in names}
    return {"losses": losses, "grad1": grad1, "raw1": raw1,
            "delta": delta3 if delta is None else delta, "delta3": delta3}
