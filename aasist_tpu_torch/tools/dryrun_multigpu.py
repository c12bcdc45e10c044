"""Dry run of the port's data-parallel surface over N ranks (the port of
``__graft_entry__.py:dryrun_multichip``), at its tiny shapes: 6,400-sample
windows, a global batch of at least 8 rows that the ranks divide.

    python -m aasist_tpu_torch.tools.dryrun_multigpu --nproc 2
    python -m aasist_tpu_torch.tools.dryrun_multigpu --nproc 2 --device cpu

It starts N ranks on a free localhost port (``parallel/launch.py``, the
environment ``torchrun`` sets), each on ``cuda:rank`` (the cards in turn
when there are fewer than N; NCCL when every rank has a card of its own,
else Gloo) or on the CPU with ``--device cpu``, and prints rank 0's lines.
The phases, on the AASIST flagship configuration of the JAX dry run:

  1. a data-parallel train step (f32, TF32 off), its loss against the
     one-process step on the whole batch;
  2. mixed precision with ``grad_accum_steps`` 2;
  3. the sharded eval pipeline: ``EvalBatcher`` rows per rank through
     ``produce_scores`` on a synthetic corpus, the scores gathered;
  4. the mesh Scorer (rank 0, one replica a device of this host) on ragged
     waveforms, against the one-device Scorer;
  5. chained eval (chain 2) with the frontend kernel split over the mesh
     (``fused_frontend_sharded``), against phase 3's scores;
  6. AASIST2's Res2Net encoder on two DCS bucket lengths with ALMFT's
     duration-adaptive margin;
  7. a RawNet2 eval batch over the ranks against the whole batch's.

A failed check or a failed rank raises, with every rank's output.
"""

from __future__ import annotations

import argparse
import copy
import sys
import tempfile
import time

import numpy as np
import torch

FLAGSHIP = {"architecture": "AASIST", "first_conv": 128,
            "filts": [70, [1, 32], [32, 32], [32, 64], [64, 64]],
            "gat_dims": [64, 32], "pool_ratios": [0.5, 0.7, 0.5, 0.5],
            "temperatures": [2.0, 2.0, 100.0, 100.0]}
AASIST2 = {**FLAGSHIP, "res2net_width": 14, "res2net_scale": 8}
RAWNET2 = {"architecture": "RawNet2Spoof", "nb_samp": 6400,
           "first_conv": 1024, "in_channels": 1,
           "filts": [20, [20, 20], [20, 32], [32, 32]], "blocks": [2, 4],
           "nb_fc_node": 24, "gru_node": 48, "nb_gru_layer": 3,
           "nb_classes": 2}
LENGTH = 6400
# f32 logits of two paths of the same function (the frontend kernel or
# another split against stock ops): chip_smoke.py's TOL_MODEL_ON_OFF
TOL = dict(atol=2e-4, rtol=1e-4)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multigpu: {msg}")


def _close(got, want, what: str) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    _check(np.allclose(got, want, **TOL), f"{what}: max|diff| {err:.3e}")
    return err


def _local_mesh(device: torch.device, n: int):
    from aasist_tpu_torch.parallel.mesh import DataMesh
    if device.type != "cuda":
        return DataMesh([device] * n)
    cards = torch.cuda.device_count()
    return DataMesh([f"cuda:{i % cards}" for i in range(n)])


def run_rank(workdir: str, device: str) -> None:
    """The seven phases on this rank (``WORLD_SIZE`` and the rest set)."""
    from aasist_tpu_torch.config import OptimConfig
    from aasist_tpu_torch.data import synthetic
    from aasist_tpu_torch.data.dataset import AudioStore, EvalBatcher
    from aasist_tpu_torch.parallel import mesh
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.serving import Scorer
    from aasist_tpu_torch.train.loop import make_train_step, produce_scores
    from aasist_tpu_torch.train.losses import am_softmax, weighted_cce
    from aasist_tpu_torch.train.optim import create_optimizer, make_schedule

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = mesh.from_env(device)
    try:
        n = ranks.world
        dev = ranks.device
        tag = f"dryrun_multigpu({n})"
        say = print if ranks.main else (lambda *a, **k: None)
        backend = (torch.distributed.get_backend() if ranks.distributed
                   else "none")
        say(f"{tag}: {n} ranks on {dev.type}, backend {backend}", flush=True)
        batch = n * -(-8 // n)
        share = batch // n
        rows = mesh.local_rows(batch, ranks.rank, n)
        x = np.random.default_rng(0).standard_normal(
            (batch, LENGTH)).astype(np.float32)
        y = torch.arange(batch) % 2
        dur = torch.full((batch,), LENGTH / 16000.0)
        cfg = OptimConfig.from_dict({"optimizer": "adam", "base_lr": 1e-4,
                                     "scheduler": "none"})

        def cce(lg, yy, dd, ranks=None):
            return weighted_cce(lg, yy, ranks=ranks)

        def train_step(conf, on_ranks, **kw):
            torch.manual_seed(0)
            model = build_model(conf).to(dev).train()
            opt = create_optimizer(cfg, model.parameters())
            return model, make_train_step(
                model, kw.pop("loss", cce), opt, make_schedule(cfg), seed=1,
                freq_aug=False, use_duration=kw.pop("use_duration", False),
                ranks=ranks if on_ranks else None, **kw)

        def to(t):
            return torch.as_tensor(t).to(dev)

        # ---- 1: a data-parallel f32 step against the one-process step
        t0 = time.perf_counter()
        model, step = train_step(FLAGSHIP, True)
        before = [p.detach().clone() for p in model.parameters()]
        loss = float(step(to(x[rows]), to(y[rows]), to(dur[rows]), 0)[0])
        moved = sum(float((p.detach() - b).abs().sum())
                    for p, b in zip(model.parameters(), before))
        _check(np.isfinite(loss) and moved > 0,
               f"DP step: loss {loss}, parameters moved {moved}")
        _, one = train_step(FLAGSHIP, False)
        want = float(one(to(x), to(y), to(dur), 0)[0])
        err = _close(loss, want, "DP step loss against one process")
        say(f"{tag}: DP train step loss={loss:.6f} (one process "
            f"{want:.6f}, |diff| {err:.2e}), {time.perf_counter() - t0:.1f} s",
            flush=True)

        # ---- 2: mixed precision + two accumulated microbatches
        _, step = train_step(FLAGSHIP, True, grad_accum_steps=2,
                             mixed_precision=True)
        rows2 = mesh.local_rows(batch * 2, ranks.rank, n, groups=2)
        x2, y2 = np.concatenate([x, x[::-1]]), torch.cat([y, y.flip(0)])
        d2 = torch.cat([dur, dur])
        loss2 = float(step(to(x2[rows2]), to(y2[rows2]), to(d2[rows2]),
                           0)[0])
        _check(np.isfinite(loss2), f"bf16 + grad_accum=2 loss {loss2}")
        say(f"{tag}: bf16 + grad_accum=2 loss={loss2:.4f}", flush=True)

        # ---- 3: the sharded eval pipeline
        root = f"{workdir}/LA"
        if ranks.main:
            synthetic.generate(root, n_train=2, n_dev=2, n_eval=2 * batch,
                               seed=0, audio_format="wav")
        ranks.barrier()
        torch.manual_seed(0)
        model = build_model(FLAGSHIP).to(dev).eval()
        store = AudioStore(f"{root}/ASVspoof2019_LA_eval")
        ids = sorted(p.stem for p in (store.base_dir / "flac").iterdir())
        sharded = EvalBatcher(store, ids, batch_size=batch, fixed_len=LENGTH,
                              rank=ranks.rank, world=n)
        utts, scores = produce_scores(model, sharded, ranks=ranks)
        _check(utts == ids and np.isfinite(scores).all(),
               "sharded eval scored other utterances or non-finite scores")
        say(f"{tag}: sharded eval scored {len(scores)} utts, {share} rows "
            "a rank a batch", flush=True)

        if ranks.main:
            # ---- 4: the mesh Scorer on this host's devices
            local = _local_mesh(dev, n)
            bf16 = dev.type == "cuda"
            kw = dict(batch_size=batch, window=LENGTH, bf16=bf16)
            rng = np.random.default_rng(1)
            wavs = [rng.standard_normal(k).astype(np.float32)
                    for k in (3200, 6400, 9000, 6400, 500)]
            served = Scorer(model, mesh=local, **kw).score_waveforms(wavs)
            single = Scorer(model, device=dev, **kw).score_waveforms(wavs)
            _check(len(served) == len(wavs) and np.isfinite(served).all(),
                   "mesh Scorer: non-finite or missing scores")
            d4 = float(np.abs(np.subtract(served, single)).max())
            _check(d4 <= (0.1 if bf16 else 1e-4),
                   f"mesh Scorer off the one-device Scorer by {d4}")
            say(f"{tag}: mesh Scorer over {local} OK (|diff| to one "
                f"device {d4:.2e})", flush=True)

            # ---- 5: chained eval, the frontend kernel over the mesh
            fe = copy.deepcopy(model)
            fe.use_fused_frontend, fe.mesh = True, local
            whole = EvalBatcher(store, ids, batch_size=batch,
                                fixed_len=LENGTH)
            utts5, scores5 = produce_scores(fe, whole, chain=2)
            _check(utts5 == utts, "chained eval scored other utterances")
            err5 = _close(scores5, scores, "chained + sharded frontend eval "
                          "against phase 3")
            say(f"{tag}: chained+fused mesh eval OK (max drift "
                f"{err5:.2e})", flush=True)
        ranks.barrier()

        # ---- 6: AASIST2 on two DCS buckets with ALMFT
        def almft(lg, yy, dd, ranks=None):
            return am_softmax(lg, yy, scale=15.0, margin=0.2, durations=dd,
                              margin_a=0.06, margin_b=0.14, ranks=ranks)

        _, step6 = train_step(AASIST2, True, loss=almft, use_duration=True)
        rng6 = np.random.default_rng(6)
        for i, blen in enumerate((6400, 9600)):
            xb = rng6.standard_normal((batch, blen)).astype(np.float32)
            db = torch.full((batch,), blen / 16000.0)
            loss6 = float(step6(to(xb[rows]), to(y[rows]), to(db[rows]),
                                i)[0])
            _check(np.isfinite(loss6), f"ALMFT loss {loss6} at L={blen}")
            say(f"{tag}: DCS bucket L={blen} ALMFT train step "
                f"loss={loss6:.4f}", flush=True)

        # ---- 7: RawNet2 eval over the ranks
        torch.manual_seed(7)
        rawnet = build_model(RAWNET2).to(dev).eval()
        x7 = rng6.standard_normal((batch, LENGTH)).astype(np.float32)
        with torch.inference_mode():
            got = ranks.all_gather(rawnet(to(x7[rows]))[1]).cpu().numpy()
            want7 = rawnet(to(x7))[1].cpu().numpy()
        _check(got.shape == (batch, 2), f"RawNet2 logits {got.shape}")
        err7 = _close(got, want7, "RawNet2 over the ranks")
        say(f"{tag}: RawNet2 mesh eval OK (|diff| {err7:.2e}) - all phases "
            "passed", flush=True)
    finally:
        mesh.shutdown(ranks)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="seconds a rank may run")
    parser.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    import os
    if "RANK" in os.environ:
        run_rank(args.workdir, args.device)
        return 0
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multigpu: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    from aasist_tpu_torch.parallel import launch
    with tempfile.TemporaryDirectory() as workdir:
        outs = launch.spawn(
            [sys.executable, "-m", "aasist_tpu_torch.tools.dryrun_multigpu",
             "--nproc", str(args.nproc), "--device", args.device,
             "--workdir", workdir], args.nproc, timeout=args.timeout)
    print(outs[0], end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
