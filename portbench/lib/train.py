"""The driver of the ``train`` traffic kind: the step of
``aasist_tpu_torch/train/loop.py:make_train_step`` fed by
``data/dataset.py:TrainBatcher``.

Set-up writes the mix's corpus as 16-bit WAV files under a directory made
in ``TMPDIR`` (deleted at the end), builds the model from the
configuration with the benchmark's weights, and builds the optimizer,
schedule, loss and step as ``run_training`` builds them.  It then drives
that one step through the first three batches of epoch 0, which go
through the window's own call and feed, and keeps what the check
compares: each step's loss, the first gradient as Adam took it (its first
moment after one step over 1 - beta1), and the parameters before and
after the three.  The window continues the same iterator with the body of
``run_training``'s epoch loop: the batch copied to the card without
blocking, the step, the pending losses drained every 50 batches, under the
configuration's precision (``cli.full_f32`` for float32); it ends on a
synchronise, so every step counted has finished.  The per-epoch scoring,
checkpoints and SWA of ``run_training`` lie outside the window.
"""

from __future__ import annotations

import contextlib
import math
import shutil
import tempfile
import time
from pathlib import Path
from typing import List

import torch

from portbench.lib import compare, traffic, weights
from portbench.lib import run as runlib
from portbench.lib import trace as tr
from portbench.lib.score import load_program_model
from portbench.reference import training as ref_train

WARM_STEPS = 3
DRAIN_EVERY = 50        # run_training's print and drain period


def experiment_config(cell):
    from aasist_tpu_torch.config import ExperimentConfig

    train = {k: v for k, v in cell.config["train"].items()
             if k not in ("dtype", "weights")}
    return ExperimentConfig.from_dict(
        {**train, "model_config": cell.config["model_config"]})


def run(cell, seed: int, seconds: float, trace: bool, device, keep: bool
        ) -> "runlib.Outcome":
    from aasist_tpu_torch.cli import full_f32
    from aasist_tpu_torch.data.dataset import AudioStore, TrainBatcher
    from aasist_tpu_torch.train.loop import RobustOptions, make_train_step
    from aasist_tpu_torch.train.losses import make_loss_fn
    from aasist_tpu_torch.train.optim import create_optimizer, make_schedule

    mix, tc = cell.traffic, cell.config["train"]
    mc, ref = cell.config["model_config"], cell.reference
    model = load_program_model(
        mc, weights.of_config(tc["weights"], ref, mc, seed, device,
                              cell.root))
    model = model.to(device).train()
    cfg = experiment_config(cell)
    ids, pcm, labels = traffic.make_corpus(mix, seed, device)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        traffic.write_wavs(tmp / "flac", ids, pcm)
        batcher = TrainBatcher(AudioStore(tmp), ids, labels,
                               batch_size=cfg.batch_size, seed=seed,
                               fixed_len=mix["crop"],
                               pin_memory=device.type == "cuda")
        cfg.optim_config.steps_per_epoch = len(batcher)
        cfg.optim_config.epochs = cfg.num_epochs
        optimizer = create_optimizer(cfg.optim_config, model.parameters())
        schedule = make_schedule(cfg.optim_config)
        loss_fn, use_duration = make_loss_fn(cfg.loss, cfg)
        step = make_train_step(
            model, loss_fn, optimizer, schedule, seed=seed,
            freq_aug=cfg.freq_aug, use_duration=use_duration,
            grad_accum_steps=int(cfg.extras.get("grad_accum_steps", 1)),
            mixed_precision=cfg.extra_flag("mixed_precision"),
            robust=RobustOptions.from_config(cfg))
        precision = (full_f32 if tc["dtype"] == "float32"
                     else contextlib.nullcontext)
        loop = _Loop(batcher, step, device)
        params = dict(model.named_parameters())
        beta1 = cfg.optim_config.betas[0]
        with precision():
            p0 = {n: p.detach().clone() for n, p in params.items()}
            warm = []
            for i in range(WARM_STEPS):
                loop.step()
                warm.append(loop.last_loss)
                if i == 0:
                    grad1 = {n: optimizer.state[p]["exp_avg"] / (1 - beta1)
                             for n, p in params.items()
                             if p in optimizer.state}
                if i == 1:
                    delta = {n: p.detach() - p0[n]
                             for n, p in params.items()}
            delta3 = {n: p.detach() - p0[n] for n, p in params.items()}
            program = {"losses": [float(v) for v in warm], "grad1": grad1,
                       "delta": delta, "delta3": delta3}
            tr.synchronize()

            setup_s = tr.process_age_s()
            first = loop.global_step
            with tr.window(trace) as prof:
                w0 = time.perf_counter()
                while time.perf_counter() - w0 < seconds:
                    loop.step()
                loop.drain()
                tr.synchronize()
                elapsed = time.perf_counter() - w0
        memory = runlib.peak_memory(device)
        trace_ = tr.read(prof) if prof is not None else None
        steps = loop.global_step - first
        window_losses = loop.losses[first:]
        waits = loop.waits[first:]
        loop.close()
        del loop, step, optimizer, model, params, prof
        runlib.free(device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    failed = sum(not math.isfinite(v) for v in window_losses)
    rows = steps * cfg.batch_size
    end_to_end = {"setup_s": setup_s, "train_utt_s": rows / elapsed}
    counts = {"steps": steps, "rows": rows, "window_s": elapsed}
    host = {"loader_wait_ms": _mean_ms(waits)}
    data = list(ref_train.batches(pcm, ids, labels, seed, cfg.batch_size,
                                  mix["crop"], WARM_STEPS))
    P_ref = weights.of_config(tc["weights"], ref, mc, seed, device,
                              cell.root)
    reference = ref_train.follow(ref, P_ref, data, mc, tc, seed,
                                 len(ids) // cfg.batch_size, device)
    readings = compare.train_readings(program, reference)
    kept = ({"data": data, "P": P_ref, "reference": reference,
             "program": program, "steps_per_epoch": len(ids)
             // cfg.batch_size} if keep else {})
    return runlib.Outcome(end_to_end, counts, host, readings, steps, failed,
                          memory, trace_, kept)


def _mean_ms(values: List[float]) -> float:
    return 1e3 * sum(values) / len(values) if values else math.nan


class _Loop:
    """The body of ``run_training``'s epoch loop over one iterator of the
    batcher, continued into the next epoch when one ends."""

    def __init__(self, batcher, step, device):
        self.batcher, self.train_step, self.device = batcher, step, device
        self.epoch, self.batch_idx, self.next_print = 0, 0, 0
        self.global_step = 0
        batcher.set_epoch(0)
        self.it = iter(batcher)
        self.pending: List = []
        self.losses: List[float] = []     # drained, in step order
        self.waits: List[float] = []      # seconds in next(), per step
        self.last_loss = None

    def _next(self):
        try:
            return next(self.it)
        except StopIteration:
            self.epoch += 1
            self.batch_idx = self.next_print = 0
            self.batcher.set_epoch(self.epoch)
            self.it = iter(self.batcher)
            return next(self.it)

    def step(self) -> None:
        t0 = time.perf_counter()
        with tr.span("portbench.next"):
            batch = self._next()
        self.waits.append(time.perf_counter() - t0)
        x, y, dur = (t.to(self.device, non_blocking=True) for t in batch)
        with tr.span("portbench.step"):
            loss, corr = self.train_step(x, y, dur, self.global_step)
        self.pending.append(loss)
        self.last_loss = loss
        self.global_step += 1
        if self.batch_idx >= self.next_print:
            with tr.span("portbench.drain"):
                self.drain()
            self.next_print += DRAIN_EVERY
        self.batch_idx += 1

    def drain(self) -> None:
        self.losses.extend(float(v) for v in self.pending)
        self.pending.clear()

    def close(self) -> None:
        self.it.close()
