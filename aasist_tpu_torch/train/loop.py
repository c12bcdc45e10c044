"""Training and batched evaluation (counterpart of
``aasist_tpu/train/loop.py``).

Training: ``make_train_step`` builds one optimizer step (forward, loss,
backward, lr from the schedule, ``optimizer.step()``) over one batch or
``grad_accum_steps`` microbatches, in f32 or ``mixed_precision``;
``run_training`` is the reference's epoch protocol (per-epoch dev scoring,
best-dev snapshots, ``eval_all_best``, SWA snapshots on best-dev, the train
state each epoch, the final SWA swap, BN re-estimation and eval) with
resume.  Each step's random draws (dropout, ``freq_aug``'s mask, input
noise) come from an ``nn.RngStream`` keyed (seed + 1, global step,
microbatch), and the batcher's from (seed, epoch, batch, row), so a
resumed run needs no saved generator state and repeats the straight run's
draws.  The JAX package's ``train_chain`` batches K steps into one
dispatch; here the key is accepted and the steps run one after another,
the same data and the same draws.  The robust-training extras
(``use_mixup``, ``adv_training``) are not ported (ROADMAP.md).

Evaluation (``make_eval_step``, ``make_chained_eval_step``,
``produce_scores``, ``evaluate_to_file``):
The score of an utterance is ``logits[:, 1]``, the reference's.  Batches
come from an ``EvalBatcher`` on the host and are dispatched
``pipeline_depth`` deep (``utils/dispatch.py:pipelined``).  On a card each
dispatch writes its batch (or its chain of batches) into a pinned slot of a
``SlotRing``, copies it to the device without blocking, queues the
forwards and the scores' copy back, and records an event; a drain waits for
that event only.  On the CPU each dispatch computes at once.

The model carries its weights, so the steps take the input alone.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from aasist_tpu_torch import nn
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


# ------------------------------------------------------------------ training
def forward_fn(model: torch.nn.Module, mixed_precision: bool = False
               ) -> Callable:
    """(x, rngs, freq_aug) -> the model's outputs.  With
    ``mixed_precision`` the forward runs on bf16 copies of every f32
    parameter and buffer, BatchNorm's weights and running statistics
    included, cast inside the differentiated function so that gradients
    arrive in f32 on the f32 masters; the statistics a train-mode
    BatchNorm writes into its bf16 copies are cast back into the f32
    masters after the forward.  This is the JAX package's step
    (``aasist_tpu/train/loop.py:_make_loss_and_grads``): parameters and
    state cast to bf16, the new statistics cast back to f32."""
    if not mixed_precision:
        return lambda x, rngs, freq_aug: model(x, rngs=rngs,
                                               freq_aug=freq_aug)
    def run(x, rngs, freq_aug):
        stats = [(f"{name}.{t}" if name else t, b)
                 for name, m in model.named_modules()
                 if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                 for t, b in m.named_buffers(recurse=False)
                 if b.dtype == torch.float32]
        tensors = {
            n: t.to(torch.bfloat16) if t.dtype == torch.float32 else t
            for n, t in [*model.named_parameters(), *model.named_buffers()]}
        out = torch.func.functional_call(
            model, tensors, (x,), {"rngs": rngs, "freq_aug": freq_aug})
        with torch.no_grad():
            for n, master in stats:
                master.copy_(tensors[n])
        return out

    return run


def make_train_step(model: torch.nn.Module, loss_fn, optimizer, schedule,
                    *, seed: int, freq_aug: bool, use_duration: bool,
                    grad_accum_steps: int = 1,
                    mixed_precision: bool = False,
                    dropout: bool = True) -> Callable:
    """step(x, y, durations, global_step) -> (loss, n_correct), both
    0-d device tensors (no host sync); the model must be in train mode.

    Sets the lr to ``schedule(global_step)``, clears the gradients to
    ``None``, and runs the forward and backward of each of
    ``grad_accum_steps`` equal microbatches (the loss of each divided by
    their count, so the gradients are their mean; BatchNorm's statistics
    move once a microbatch), then ``optimizer.step()``.  A batch the count
    does not divide raises.  Microbatch i draws from the stream keyed
    (seed + 1, global_step, i); ``dropout=False`` turns the dropouts off
    and keeps BatchNorm in train mode, the setting the reference's goldens
    and the differentials against the JAX package run in.  The loss is
    computed in f32 from bf16 logits, and in the logits' own type
    otherwise.
    """
    run = forward_fn(model, mixed_precision)
    k = int(grad_accum_steps)

    def step(x, y, durations, global_step: int):
        if x.shape[0] % k:
            raise ValueError(
                f"batch size {x.shape[0]} is not divisible by "
                f"grad_accum_steps {k}; the tail {x.shape[0] % k} rows "
                "would be dropped: use a divisible batch size or adjust "
                "grad_accum_steps")
        for group in optimizer.param_groups:
            group["lr"] = schedule(global_step)
        optimizer.zero_grad(set_to_none=True)
        loss_sum = n_correct = 0
        for i, (xs, ys, ds) in enumerate(zip(x.chunk(k), y.chunk(k),
                                             durations.chunk(k))):
            logits = run(xs, nn.RngStream((seed + 1, global_step, i),
                                          dropout_enabled=dropout),
                         freq_aug)[1]
            if logits.dtype in (torch.bfloat16, torch.float16):
                logits = logits.float()
            loss = loss_fn(logits, ys, ds if use_duration else None)
            (loss / k).backward()
            loss_sum = loss_sum + loss.detach()
            n_correct = n_correct + (logits.argmax(-1) == ys).sum()
        optimizer.step()
        return loss_sum / k, n_correct

    return step


def check_robust_options(cfg) -> None:
    """The JAX package's opt-in robust-training extras are not ported: a
    config that turns one on raises."""
    on = [k for k in ("use_mixup", "adv_training") if cfg.extra_flag(k)]
    if on:
        raise NotImplementedError(
            f"{on}: the mixup / PGD robust-training extras are not ported to "
            "PyTorch yet (ROADMAP.md, queue 1)")


class Loaders(NamedTuple):
    train: Any                # data.dataset.TrainBatcher
    dev: Any                  # data.dataset.EvalBatcher
    eval: Any
    dev_trial_meta: Dict
    eval_trial_meta: Dict


def run_training(cfg, model: torch.nn.Module, loaders: Loaders, run_dir, *,
                 seed: int = 1234, resume: bool = False,
                 asv_scores_path=None, max_epochs: Optional[int] = None,
                 precision=contextlib.nullcontext) -> Dict[str, float]:
    """The reference's training protocol on ``model``'s device; returns the
    best and final metrics.  ``precision`` is a context manager factory
    entered around the steps and the scoring (the CLI's TF32 switch)."""
    from aasist_tpu_torch.evaluation.metrics import calculate_tdcf_eer
    from aasist_tpu_torch.train import checkpoints as ckpt_lib
    from aasist_tpu_torch.train.losses import make_loss_fn
    from aasist_tpu_torch.train.optim import create_optimizer, make_schedule
    from aasist_tpu_torch.train.swa import SWAState, reestimate_bn_stats
    from aasist_tpu_torch.utils.logging import MetricsLogger
    from aasist_tpu_torch.weights import save_npz

    check_robust_options(cfg)
    run_dir = Path(run_dir)
    weights_dir = run_dir / "weights"
    metric_dir = run_dir / "metrics"
    weights_dir.mkdir(parents=True, exist_ok=True)
    metric_dir.mkdir(parents=True, exist_ok=True)
    log = MetricsLogger(run_dir)
    device = next(model.parameters()).device

    asv_scores_path = asv_scores_path or cfg.asv_scores()
    steps_per_epoch = len(loaders.train)
    cfg.optim_config.steps_per_epoch = steps_per_epoch
    cfg.optim_config.epochs = cfg.num_epochs
    optimizer = create_optimizer(cfg.optim_config, model.parameters())
    schedule = make_schedule(cfg.optim_config)
    loss_fn, use_duration = make_loss_fn(cfg.loss, cfg)
    mp = cfg.extra_flag("mixed_precision")
    train_step = make_train_step(
        model, loss_fn, optimizer, schedule, seed=seed,
        freq_aug=cfg.freq_aug, use_duration=use_duration,
        grad_accum_steps=int(cfg.extras.get("grad_accum_steps", 1)),
        mixed_precision=mp)
    eval_chain = int(cfg.extras.get("eval_chain", 1))

    start_epoch = 0
    # the reference starts best_dev_eer at 1.0 with EERs in percent, so it
    # would snapshot nothing until dev EER <= 1 %: start at the maxima
    best = {"dev_eer": 100.0, "eval_eer": 100.0, "dev_tdcf": 1.0,
            "eval_tdcf": 1.0}
    swa = SWAState()
    state_dir = run_dir / "train_state"
    if resume and (state_dir.exists() or state_dir.with_name(
            state_dir.name + ".old").exists()):
        meta = ckpt_lib.load_train_state(state_dir, model, optimizer, swa)
        start_epoch = meta["epoch"] + 1
        best["dev_eer"] = meta["best_dev_eer"]
        best["eval_eer"] = meta["best_eval_eer"]
        best["eval_tdcf"] = meta["best_eval_tdcf"]

    def score(batcher, trial_meta, path):
        model.eval()
        evaluate_to_file(model, batcher, trial_meta, path, chain=eval_chain)

    n_epochs = max_epochs if max_epochs is not None else cfg.num_epochs
    global_step = start_epoch * steps_per_epoch
    train_loss = float("nan")
    for epoch in range(start_epoch, n_epochs):
        loaders.train.set_epoch(epoch)
        model.train()
        t0 = time.time()
        loss_sum, n_correct, n_seen = 0.0, 0, 0
        pending: List[Tuple[torch.Tensor, torch.Tensor, int]] = []

        def drain():
            nonlocal loss_sum, n_correct, n_seen
            for dloss, dcorr, bs in pending:
                loss_sum += float(dloss) * bs
                n_correct += int(dcorr)
                n_seen += bs
            pending.clear()

        next_print = 0
        with precision():
            for batch_idx, (x, y, dur) in enumerate(loaders.train):
                x, y, dur = (t.to(device, non_blocking=True)
                             for t in (x, y, dur))
                loss, corr = train_step(x, y, dur, global_step)
                pending.append((loss, corr, x.shape[0]))
                global_step += 1
                if batch_idx >= next_print:
                    drain()
                    print(f"epoch {epoch:03d} batch {batch_idx}/"
                          f"{steps_per_epoch} loss={loss_sum / n_seen:.4f} "
                          f"acc={100 * n_correct / n_seen:.2f}% "
                          f"lr={schedule(global_step):.2e}", flush=True)
                    next_print += 50
            drain()
        train_loss = loss_sum / max(n_seen, 1)
        log.scalar("loss", train_loss, epoch)
        log.scalar("train_acc", 100.0 * n_correct / max(n_seen, 1), epoch)
        log.scalar("lr", schedule(global_step), epoch)
        log.scalar("epoch_seconds", time.time() - t0, epoch)

        dev_score_path = metric_dir / "dev_score.txt"
        with precision():
            score(loaders.dev, loaders.dev_trial_meta, dev_score_path)
        dev_eer, dev_tdcf = calculate_tdcf_eer(
            dev_score_path, asv_scores_path,
            metric_dir / f"dev_t-DCF_EER_{epoch}epo.txt", printout=False)
        log.scalar("dev_eer", dev_eer, epoch)
        log.scalar("dev_tdcf", dev_tdcf, epoch)

        best["dev_tdcf"] = min(dev_tdcf, best["dev_tdcf"])
        if best["dev_eer"] >= dev_eer:
            best["dev_eer"] = dev_eer
            save_npz(
                model, weights_dir / f"epoch_{epoch}_{dev_eer:03.3f}.npz")
            if cfg.eval_all_best:
                eval_score_path = run_dir / cfg.eval_output
                with precision():
                    score(loaders.eval, loaders.eval_trial_meta,
                          eval_score_path)
                eval_eer, eval_tdcf = calculate_tdcf_eer(
                    eval_score_path, asv_scores_path,
                    metric_dir / f"t-DCF_EER_{epoch:03d}epo.txt",
                    printout=False)
                log_text = f"epoch{epoch:03d}, "
                if eval_eer < best["eval_eer"]:
                    log_text += f"best eer, {eval_eer:.4f}%"
                    best["eval_eer"] = eval_eer
                if eval_tdcf < best["eval_tdcf"]:
                    log_text += f"best tdcf, {eval_tdcf:.4f}"
                    best["eval_tdcf"] = eval_tdcf
                    save_npz(model, weights_dir / "best.npz")
                log.text(log_text)
            swa.update(dict(model.named_parameters()))

        log.scalar("best_dev_eer", best["dev_eer"], epoch)
        log.scalar("best_dev_tdcf", best["dev_tdcf"], epoch)
        ckpt_lib.save_train_state(state_dir, model, optimizer, swa, {
            "step": global_step, "epoch": epoch,
            "best_dev_eer": best["dev_eer"],
            "best_eval_eer": best["eval_eer"],
            "best_eval_tdcf": best["eval_tdcf"]})

    # final: SWA swap, BatchNorm re-estimation, eval (the reference's)
    if swa.n > 0:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(swa.avg[name])
        loaders.train.set_epoch(n_epochs)
        with precision():
            reestimate_bn_stats(model, loaders.train, mixed_precision=mp)

    eval_score_path = run_dir / cfg.eval_output
    with precision():
        score(loaders.eval, loaders.eval_trial_meta, eval_score_path)
    eval_eer, eval_tdcf = calculate_tdcf_eer(
        eval_score_path, asv_scores_path, run_dir / "t-DCF_EER.txt",
        printout=False)
    log.text(f"EER: {eval_eer:.3f}, min t-DCF: {eval_tdcf:.5f}")
    save_npz(model, weights_dir / "swa.npz")
    if eval_eer <= best["eval_eer"]:
        best["eval_eer"] = eval_eer
    if eval_tdcf <= best["eval_tdcf"]:
        best["eval_tdcf"] = eval_tdcf
        save_npz(model, weights_dir / "best.npz")
    log.close()
    return {"eval_eer": best["eval_eer"], "eval_tdcf": best["eval_tdcf"],
            "dev_eer": best["dev_eer"], "final_eval_eer": eval_eer,
            "final_eval_tdcf": eval_tdcf, "train_loss": train_loss}
