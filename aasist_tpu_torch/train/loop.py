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
(``RobustOptions``: waveform mixup, PGD adversarial training) apply per
microbatch, as in the JAX package.

Data parallelism (``ranks``, ``parallel/mesh.py``): each rank holds its
rows of every global batch, and a step computes what one process
computes on the whole batch: BatchNorm's statistics, the losses'
normalisers and the draws are global, mixup permutes the global rows, and
the gradients are summed over the ranks before the optimizer's step.
Scores are gathered in utterance order; rank 0 writes the files and its
dev EER decides for every rank.

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
import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from aasist_tpu_torch import nn
from aasist_tpu_torch.evaluation.scorefile import write_score_file
from aasist_tpu_torch.parallel.mesh import (Ranks, row_shard,
                                            sync_batch_norm)
from aasist_tpu_torch.utils.dispatch import SlotRing, pipelined, record
from aasist_tpu_torch.utils.profiling import annotate


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
                   pipeline_depth: int = 2, chain: int = 1,
                   ranks: Optional[Ranks] = None
                   ) -> Tuple[List[str], List[float]]:
    """Run batched inference; returns (utt_ids, bonafide scores).

    ``batcher`` yields ``(x (B, L) float32 numpy, utt_ids, n_real)`` with
    one B; only the scores of each batch's ``len(utt_ids)`` first rows are
    kept.  ``chain`` > 1 stacks that many batches into one dispatched
    call (``make_chained_eval_step``); the final partial group is padded by
    repeating its last batch, and the padding's rows are dropped when the
    group is drained.  With ``chain`` > 1 a given ``eval_step`` must be a
    chained step over (chain, B, L).  With ``ranks`` the batcher yields
    this rank's rows of each batch (``data/dataset.py:EvalBatcher``) and
    the batch's ``utt_ids``: the scores are gathered over the ranks, so
    every rank returns them all.
    """
    device = next(model.parameters()).device
    ranks = ranks or Ranks.single(device)
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
                scores = ranks.all_gather(out[..., 1].float(), dim=1)
                return scores.cpu().numpy(), None, 0, gu
            if ring is None:
                ring = SlotRing(pipeline_depth + 1, (chain, *gx[0].shape),
                                chain * gx[0].shape[0] * ranks.world)
            slot = ring.acquire()
            host = slot.rows.numpy()
            for g, x in enumerate(gx):
                host[g] = x
            with torch.cuda.device(device):
                out = run(slot.rows.to(device, non_blocking=True))
                scores = ranks.all_gather(out[..., 1].float(), dim=1)
                slot.scores.copy_(scores.reshape(-1), non_blocking=True)
                slot.events = [record(device)]
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
                     chain: int = 1, pipeline_depth: int = 2,
                     ranks: Optional[Ranks] = None) -> None:
    """Score every utterance of ``batcher`` and write the score file (rank
    0 of ``ranks`` writes it).  A chain longer than the set's batch count
    would only score padding: without a given ``eval_step`` (one built for
    its own ``chain``) it is clamped to the count."""
    utt_ids = getattr(batcher, "utt_ids", None)
    bs = getattr(batcher, "batch_size", None)
    if eval_step is None and utt_ids is not None and bs:
        n_batches = max(1, -(-len(utt_ids) // bs))
        chain = max(1, min(chain, n_batches))
    ids, scores = produce_scores(model, batcher, eval_step,
                                 pipeline_depth=pipeline_depth, chain=chain,
                                 ranks=ranks)
    if ranks is None or ranks.main:
        write_score_file(score_path, ids, scores, trial_meta)


# ------------------------------------------------------------------ training
def forward_fn(model: torch.nn.Module, mixed_precision: bool = False
               ) -> Callable:
    """(x, rngs, freq_aug, keep_stats=True) -> the model's outputs.  With
    ``mixed_precision`` the forward runs on bf16 copies of every f32
    parameter and buffer, BatchNorm's weights and running statistics
    included, cast inside the differentiated function so that gradients
    arrive in f32 on the f32 masters; the statistics a train-mode
    BatchNorm writes into its bf16 copies are cast back into the f32
    masters after the forward.  This is the JAX package's step
    (``aasist_tpu/train/loop.py:_make_loss_and_grads``): parameters and
    state cast to bf16, the new statistics cast back to f32.
    ``keep_stats=False`` runs on copies of the buffers and drops the
    statistics it moves (the robust step's extra forwards)."""
    def run(x, rngs, freq_aug, keep_stats=True):
        kwargs = {"rngs": rngs, "freq_aug": freq_aug}
        if not mixed_precision:
            if keep_stats:
                return model(x, **kwargs)
            return torch.func.functional_call(
                model, {n: b.clone() for n, b in model.named_buffers()},
                (x,), kwargs)
        stats = [(f"{name}.{t}" if name else t, b)
                 for name, m in model.named_modules()
                 if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                 for t, b in m.named_buffers(recurse=False)
                 if b.dtype == torch.float32]
        tensors = {
            n: t.to(torch.bfloat16) if t.dtype == torch.float32 else t
            for n, t in model.named_parameters()}
        tensors.update({
            n: t.to(torch.bfloat16) if t.dtype == torch.float32
            else t if keep_stats else t.clone()
            for n, t in model.named_buffers()})
        out = torch.func.functional_call(model, tensors, (x,), kwargs)
        if keep_stats:
            with torch.no_grad():
                for n, master in stats:
                    master.copy_(tensors[n])
        return out

    return run


@dataclasses.dataclass(frozen=True)
class RobustOptions:
    """The robust-training extras (the JAX package's ``RobustOptions``):
    waveform mixup, and PGD adversarial training on the input waveform
    mixed into the loss at ``adv_ratio``.  Keys of the reference's
    AASIST-Robust.conf that the reference itself never implements; off by
    default."""

    use_mixup: bool = False
    mixup_alpha: float = 0.3
    adv_training: bool = False
    adv_epsilon: float = 0.02
    adv_alpha: float = 0.01
    adv_steps: int = 3
    adv_ratio: float = 0.5

    @classmethod
    def from_config(cls, cfg) -> "RobustOptions":
        ex = cfg.extras
        return cls(
            use_mixup=cfg.extra_flag("use_mixup"),
            mixup_alpha=float(ex.get("mixup_alpha", 0.3)),
            adv_training=cfg.extra_flag("adv_training"),
            adv_epsilon=float(ex.get("adv_epsilon", 0.02)),
            adv_alpha=float(ex.get("adv_alpha", 0.01)),
            adv_steps=int(ex.get("adv_steps", 3)),
            adv_ratio=float(ex.get("adv_ratio", 0.5)))


def mixup_draw(key: Tuple[int, ...], alpha: float, n: int
               ) -> Tuple[float, torch.Tensor]:
    """Mixup's (lam, perm) for the key: lam ~ Beta(alpha, alpha) on the
    host (numpy, from the key's ``SeedSequence``), perm a permutation of
    the n rows (a CPU generator seeded from the key)."""
    lam = np.random.default_rng(np.random.SeedSequence(list(key))).beta(
        alpha, alpha)
    perm = torch.randperm(n, generator=nn.generator_for(key, "cpu"))
    return float(lam), perm


def pgd(loss_of_input: Callable[[torch.Tensor], torch.Tensor],
        x: torch.Tensor, robust: RobustOptions) -> torch.Tensor:
    """PGD on the input: ``adv_steps`` steps of ``adv_alpha`` times the
    sign of the gradient of ``loss_of_input`` at the current point, each
    projected back into the ``adv_epsilon`` box around ``x``.  The
    gradient is taken for the input alone (``torch.autograd.grad``): no
    parameter's ``.grad`` moves."""
    x = x.detach()
    x_adv = x
    for _ in range(robust.adv_steps):
        x_adv = x_adv.detach().requires_grad_(True)
        g, = torch.autograd.grad(loss_of_input(x_adv), x_adv)
        x_adv = x_adv.detach() + robust.adv_alpha * g.sign()
        x_adv = x + (x_adv - x).clamp(-robust.adv_epsilon,
                                      robust.adv_epsilon)
    return x_adv


def make_train_step(model: torch.nn.Module, loss_fn, optimizer, schedule,
                    *, seed: int, freq_aug: bool, use_duration: bool,
                    grad_accum_steps: int = 1,
                    mixed_precision: bool = False,
                    dropout: bool = True,
                    robust: Optional[RobustOptions] = None,
                    ranks: Optional[Ranks] = None) -> Callable:
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

    ``robust`` turns on the JAX package's extras for each microbatch:
    mixup (lam and perm from ``mixup_draw`` on the key + (0, 1), both loss
    terms at the lam-weighted duration) and PGD (``adv_steps`` signed
    gradient steps on the input under the current weights, each and the
    adversarial loss drawing from a fresh stream keyed key + (0, 2); the
    input gradient through ``torch.autograd.grad``, the parameters' left
    alone; the extra forwards' BatchNorms run on copies of the buffers, so
    the statistics after the step are those the clean forward alone
    leaves).

    ``ranks``: ``x``, ``y`` and ``durations`` are this rank's rows of the
    global batch, its share of each microbatch in order
    (``parallel/mesh.py:local_rows``); ``loss_fn`` is called with
    ``ranks=``; the returned loss and count are the global batch's.

    Under a profiler (``utils/profiling.py:annotate``) a step is the span
    ``train.step``, ``global_step`` in its arguments (to find a step in a
    trace viewer), with the children ``train.zero_grad``,
    ``train.forward`` and ``train.backward`` (each microbatch's loss and
    its backward) and ``train.optimizer``.
    """
    robust = robust or RobustOptions()
    run = forward_fn(model, mixed_precision)
    k = int(grad_accum_steps)
    dp = ranks is not None and ranks.distributed
    if dp:
        sync_batch_norm(model, ranks)
    params = list(model.parameters())

    def micro(xs, ys, ds, key):
        """One microbatch's loss (differentiable) and clean logits."""
        shard = row_shard(ranks, xs.shape[0]) if dp else None

        def loss_of(logits, y, d):
            return (loss_fn(logits, y, d, ranks=ranks) if dp
                    else loss_fn(logits, y, d))

        lam = 1.0
        x_in, dur = xs, ds
        if robust.use_mixup:
            n = xs.shape[0] * (ranks.world if dp else 1)
            lam, perm = mixup_draw(key + (0, 1), robust.mixup_alpha, n)
            if dp:
                perm = perm[shard.start:shard.stop]
            perm = perm.to(xs.device)
            xg, yg, dg = ((ranks.all_gather(t) for t in (xs, ys, ds)) if dp
                          else (xs, ys, ds))
            x_in = lam * xs + (1 - lam) * xg[perm]
            y2, d2 = yg[perm], dg[perm]
            if use_duration:
                # both terms score the mixed waveform at the lam-weighted
                # duration (the JAX package's rule)
                dur = lam * ds + (1.0 - lam) * d2

        def batch_loss(xb, stream_key, keep_stats=True):
            logits = run(xb, nn.RngStream(stream_key, dropout_enabled=dropout,
                                          shard=shard), freq_aug,
                         keep_stats)[1]
            if logits.dtype in (torch.bfloat16, torch.float16):
                logits = logits.float()
            d = dur if use_duration else None
            loss = loss_of(logits, ys, d)
            if robust.use_mixup:
                loss = lam * loss + (1 - lam) * loss_of(logits, y2, d)
            return loss, logits

        loss, logits = batch_loss(x_in, key)
        if robust.adv_training:
            # the PGD and adversarial forwards move no statistics: their
            # BatchNorms run on copies of the buffers
            adv_key = key + (0, 2)
            x_adv = pgd(lambda xb: batch_loss(xb, adv_key,
                                              keep_stats=False)[0],
                        x_in, robust)
            adv_loss, _ = batch_loss(x_adv, adv_key, keep_stats=False)
            loss = (1 - robust.adv_ratio) * loss + robust.adv_ratio * adv_loss
        return loss, logits

    def step(x, y, durations, global_step: int):
        if x.shape[0] % k:
            raise ValueError(
                f"batch size {x.shape[0]} is not divisible by "
                f"grad_accum_steps {k}; the tail {x.shape[0] % k} rows "
                "would be dropped: use a divisible batch size or adjust "
                "grad_accum_steps")
        with annotate("train.step", global_step):
            for group in optimizer.param_groups:
                group["lr"] = schedule(global_step)
            with annotate("train.zero_grad"):
                optimizer.zero_grad(set_to_none=True)
            loss_sum = n_correct = 0
            for i, (xs, ys, ds) in enumerate(zip(x.chunk(k), y.chunk(k),
                                                 durations.chunk(k))):
                with annotate("train.forward"):
                    loss, logits = micro(xs, ys, ds,
                                         (seed + 1, global_step, i))
                with annotate("train.backward"):
                    (loss / k).backward()
                loss_sum = loss_sum + loss.detach()
                n_correct = n_correct + (logits.argmax(-1) == ys).sum()
            if dp:
                ranks.sum_grads(params)
                tot = ranks.sum_(torch.stack([loss_sum.double(),
                                              n_correct.double()]))
                loss_sum = tot[0].to(loss_sum.dtype)
                n_correct = tot[1].round().long()
            with annotate("train.optimizer"):
                optimizer.step()
            return loss_sum / k, n_correct

    return step


class Loaders(NamedTuple):
    train: Any                # data.dataset.TrainBatcher
    dev: Any                  # data.dataset.EvalBatcher
    eval: Any
    dev_trial_meta: Dict
    eval_trial_meta: Dict


class _NoLog:
    """The logger of a rank that is not rank 0: it writes nothing."""

    def scalar(self, name: str, value: float, step: int) -> None:
        pass

    def text(self, line: str) -> None:
        pass

    def close(self) -> None:
        pass


def run_training(cfg, model: torch.nn.Module, loaders: Loaders, run_dir, *,
                 seed: int = 1234, resume: bool = False,
                 asv_scores_path=None, max_epochs: Optional[int] = None,
                 precision=contextlib.nullcontext,
                 ranks: Optional[Ranks] = None) -> Dict[str, float]:
    """The reference's training protocol on ``model``'s device; returns the
    best and final metrics.  ``precision`` is a context manager factory
    entered around the steps and the scoring (the CLI's TF32 switch).

    With ``ranks`` in a process group the loaders hold this rank's rows
    (``cli.py:build_loaders``): every rank starts from rank 0's weights,
    steps and scores together; rank 0 writes the weights, the train state,
    the score files, the reports and the logs, and its dev EER, broadcast,
    takes every rank's best-dev, snapshot and SWA decisions.  Every rank
    reads a ``resume``'s train state."""
    from aasist_tpu_torch.evaluation.metrics import calculate_tdcf_eer
    from aasist_tpu_torch.train import checkpoints as ckpt_lib
    from aasist_tpu_torch.train.losses import make_loss_fn
    from aasist_tpu_torch.train.optim import create_optimizer, make_schedule
    from aasist_tpu_torch.train.swa import SWAState, reestimate_bn_stats
    from aasist_tpu_torch.utils.logging import MetricsLogger
    from aasist_tpu_torch.weights import save_npz

    device = next(model.parameters()).device
    ranks = ranks or Ranks.single(device)
    main = ranks.main
    run_dir = Path(run_dir)
    weights_dir = run_dir / "weights"
    metric_dir = run_dir / "metrics"
    if main:
        weights_dir.mkdir(parents=True, exist_ok=True)
        metric_dir.mkdir(parents=True, exist_ok=True)
    log = MetricsLogger(run_dir) if main else _NoLog()
    ranks.broadcast_tensors([*model.parameters(), *model.buffers()])

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
        mixed_precision=mp, robust=RobustOptions.from_config(cfg),
        ranks=ranks)
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

    def score(batcher, trial_meta, path, report):
        """Score a split; rank 0 writes the file and its report, and every
        rank gets rank 0's (EER, min t-DCF)."""
        model.eval()
        with precision():
            evaluate_to_file(model, batcher, trial_meta, path,
                             chain=eval_chain, ranks=ranks)
        eer = tdcf = 0.0
        if main:
            eer, tdcf = calculate_tdcf_eer(path, asv_scores_path, report,
                                           printout=False)
        return tuple(ranks.broadcast([eer, tdcf]))

    n_epochs = max_epochs if max_epochs is not None else cfg.num_epochs
    global_step = start_epoch * steps_per_epoch
    train_loss = float("nan")
    for epoch in range(start_epoch, n_epochs):
        loaders.train.set_epoch(epoch)
        model.train()
        t0 = time.time()
        counted = loaders.train.counters    # each batch publishes a new one
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
                pending.append((loss, corr, x.shape[0] * ranks.world))
                global_step += 1
                if batch_idx >= next_print:
                    drain()
                    if main:
                        print(f"epoch {epoch:03d} batch {batch_idx}/"
                              f"{steps_per_epoch} "
                              f"loss={loss_sum / n_seen:.4f} "
                              f"acc={100 * n_correct / n_seen:.2f}% "
                              f"lr={schedule(global_step):.2e}", flush=True)
                    next_print += 50
            drain()
        train_loss = loss_sum / max(n_seen, 1)
        log.scalar("loss", train_loss, epoch)
        log.scalar("train_acc", 100.0 * n_correct / max(n_seen, 1), epoch)
        log.scalar("lr", schedule(global_step), epoch)
        log.scalar("epoch_seconds", time.time() - t0, epoch)
        # the loader's ms a batch by stage (``TrainBatcher.counters``)
        now = loaders.train.counters
        made = max(now["batches"] - counted["batches"], 1)
        for key in ("rows_ms", "collate_ms", "pin_ms", "produce_ms"):
            log.scalar(f"loader_{key}", (now[key] - counted[key]) / made,
                       epoch)

        dev_eer, dev_tdcf = score(
            loaders.dev, loaders.dev_trial_meta, metric_dir / "dev_score.txt",
            metric_dir / f"dev_t-DCF_EER_{epoch}epo.txt")
        log.scalar("dev_eer", dev_eer, epoch)
        log.scalar("dev_tdcf", dev_tdcf, epoch)

        best["dev_tdcf"] = min(dev_tdcf, best["dev_tdcf"])
        if best["dev_eer"] >= dev_eer:
            best["dev_eer"] = dev_eer
            if main:
                save_npz(model,
                         weights_dir / f"epoch_{epoch}_{dev_eer:03.3f}.npz")
            if cfg.eval_all_best:
                eval_eer, eval_tdcf = score(
                    loaders.eval, loaders.eval_trial_meta,
                    run_dir / cfg.eval_output,
                    metric_dir / f"t-DCF_EER_{epoch:03d}epo.txt")
                log_text = f"epoch{epoch:03d}, "
                if eval_eer < best["eval_eer"]:
                    log_text += f"best eer, {eval_eer:.4f}%"
                    best["eval_eer"] = eval_eer
                if eval_tdcf < best["eval_tdcf"]:
                    log_text += f"best tdcf, {eval_tdcf:.4f}"
                    best["eval_tdcf"] = eval_tdcf
                    if main:
                        save_npz(model, weights_dir / "best.npz")
                log.text(log_text)
            swa.update(dict(model.named_parameters()))

        log.scalar("best_dev_eer", best["dev_eer"], epoch)
        log.scalar("best_dev_tdcf", best["dev_tdcf"], epoch)
        if main:
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
            reestimate_bn_stats(model, loaders.train, mixed_precision=mp,
                                ranks=ranks)

    eval_eer, eval_tdcf = score(loaders.eval, loaders.eval_trial_meta,
                                run_dir / cfg.eval_output,
                                run_dir / "t-DCF_EER.txt")
    log.text(f"EER: {eval_eer:.3f}, min t-DCF: {eval_tdcf:.5f}")
    if main:
        save_npz(model, weights_dir / "swa.npz")
    if eval_eer <= best["eval_eer"]:
        best["eval_eer"] = eval_eer
    if eval_tdcf <= best["eval_tdcf"]:
        best["eval_tdcf"] = eval_tdcf
        if main:
            save_npz(model, weights_dir / "best.npz")
    log.close()
    return {"eval_eer": best["eval_eer"], "eval_tdcf": best["eval_tdcf"],
            "dev_eer": best["dev_eer"], "final_eval_eer": eval_eer,
            "final_eval_tdcf": eval_tdcf, "train_loss": train_loss}
