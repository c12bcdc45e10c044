"""Batched evaluation (own copy of the eval half of
``aasist_tpu/train/loop.py``: ``make_eval_step``, ``make_chained_eval_step``,
``produce_scores``, ``evaluate_to_file``).

The score of an utterance is ``logits[:, 1]``, the reference's.  Batches
come from an ``EvalBatcher`` on the host and are dispatched
``pipeline_depth`` deep (``utils/dispatch.py:pipelined``).  On a card each
dispatch writes its batch (or its chain of batches) into a pinned slot of a
``SlotRing``, copies it to the device without blocking, queues the
forwards and the scores' copy back, and records an event; a drain waits for
that event only.  On the CPU each dispatch computes at once.

The model carries its weights, so the steps take the input alone.  The
training functions wait for the training slice.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from aasist_tpu_torch.evaluation.scorefile import write_score_file
from aasist_tpu_torch.utils.dispatch import SlotRing, pipelined, record


def make_eval_step(model: torch.nn.Module) -> Callable:
    """x (B, L) on the model's device -> logits (B, n_classes)."""
    def step(x: torch.Tensor) -> torch.Tensor:
        return model(x)[1]

    return step


def make_chained_eval_step(model: torch.nn.Module, chain: int) -> Callable:
    """Eval step over ``chain`` stacked batches in one call: xs
    (chain, B, L) -> logits (chain, B, n_classes).  The forwards are queued
    one after another on the device's stream, with no host wait between
    them."""
    def step(xs: torch.Tensor) -> torch.Tensor:
        return torch.stack([model(x)[1] for x in xs.unbind(0)])

    return step


def produce_scores(model: torch.nn.Module, batcher,
                   eval_step: Optional[Callable] = None,
                   pipeline_depth: int = 2, chain: int = 1
                   ) -> Tuple[List[str], List[float]]:
    """Run batched inference; returns (utt_ids, bonafide scores).

    ``batcher`` yields ``(x (B, L) float32 numpy, utt_ids, n_real)`` with
    one B; only the scores of each batch's ``len(utt_ids)`` first rows are
    kept.  ``chain`` > 1 stacks that many batches into one dispatched
    call (``make_chained_eval_step``); the final partial group is padded by
    repeating its last batch, and the padding's rows are dropped when the
    group is drained.  With ``chain`` > 1 a given ``eval_step`` must be a
    chained step over (chain, B, L).
    """
    device = next(model.parameters()).device
    ids: List[str] = []
    scores: List[float] = []
    step = eval_step if eval_step is not None else (
        make_chained_eval_step(model, chain) if chain > 1
        else make_eval_step(model))

    def groups():
        """(list of `chain` batches, their utt lists); the padding batches
        of the last group have no utt list."""
        gx, gu = [], []
        for x, utts, _n_real in batcher:
            gx.append(x)
            gu.append(utts)
            if len(gx) == chain:
                yield gx, gu
                gx, gu = [], []
        if gx:
            yield gx + [gx[-1]] * (chain - len(gx)), gu

    def run(xs: torch.Tensor) -> torch.Tensor:
        """The step on the device's input (chain, B, L) -> logits
        (chain, B, n), a given chained step's output checked for shape."""
        if chain == 1:
            return step(xs[0])[None]
        if eval_step is None:
            return step(xs)
        try:
            out = step(xs)
        except (TypeError, ValueError, RuntimeError) as e:
            # a per-batch step fed (chain, B, L) fails in the model
            raise ValueError(
                f"produce_scores(chain={chain}) needs an eval_step built by "
                "make_chained_eval_step(model, chain) over (chain, B, L) "
                f"inputs; calling it failed: {e}") from e
        if out.ndim != 3 or out.shape[0] != chain:
            raise ValueError(
                f"produce_scores(chain={chain}) needs an eval_step built by "
                "make_chained_eval_step(model, chain): the given step "
                f"returned shape {tuple(out.shape)}, expected ({chain}, B, "
                "n_classes)")
        return out

    ring: Optional[SlotRing] = None

    def dispatch(group):
        nonlocal ring
        gx, gu = group
        with torch.inference_mode():
            if device.type != "cuda":
                out = run(torch.from_numpy(np.stack(gx)).to(device))
                return out[..., 1].float().numpy(), None, 0, gu
            if ring is None:
                ring = SlotRing(pipeline_depth + 1, (chain, *gx[0].shape),
                                chain * gx[0].shape[0])
            slot = ring.acquire()
            host = slot.rows.numpy()
            for g, x in enumerate(gx):
                host[g] = x
            with torch.cuda.device(device):
                out = run(slot.rows.to(device, non_blocking=True))
                slot.scores.copy_(out[..., 1].float().reshape(-1),
                                  non_blocking=True)
                slot.event = record(device)
        return None, slot, slot.gen, gu

    def drain(ticket) -> None:
        arr, slot, gen, gu = ticket
        if slot is not None:
            slot.check(gen, "produce_scores")
            arr = slot.scores.numpy().reshape(chain, -1)
        for g, utts in enumerate(gu):
            ids.extend(utts)
            scores.extend(arr[g, :len(utts)].tolist())

    pipelined(groups(), dispatch, drain, depth=pipeline_depth)
    return ids, scores


def evaluate_to_file(model: torch.nn.Module, batcher, trial_meta,
                     score_path, eval_step: Optional[Callable] = None,
                     chain: int = 1, pipeline_depth: int = 2) -> None:
    """Score every utterance of ``batcher`` and write the score file.  A
    chain longer than the set's batch count would only score padding:
    without a given ``eval_step`` (one built for its own ``chain``) it is
    clamped to the count."""
    utt_ids = getattr(batcher, "utt_ids", None)
    bs = getattr(batcher, "batch_size", None)
    if eval_step is None and utt_ids is not None and bs:
        n_batches = max(1, -(-len(utt_ids) // bs))
        chain = max(1, min(chain, n_batches))
    ids, scores = produce_scores(model, batcher, eval_step,
                                 pipeline_depth=pipeline_depth, chain=chain)
    write_score_file(score_path, ids, scores, trial_meta)
