"""Command-line entry point (counterpart of ``aasist_tpu/cli.py``).

Trains the configured model on an ASVspoof2019 corpus, or with ``--eval``
scores its eval split::

    python -m aasist_tpu_torch.cli --config configs/AASIST.conf \\
        [--output_dir DIR] [--seed N] [--comment TAG] [--resume] \\
        [--debug_subset N_TRAIN N_DEV N_EVAL] [--device cuda|cpu]
    python -m aasist_tpu_torch.cli --config configs/AASIST.conf --eval \\
        [--eval_model_weights W.npz|W.pth] [--output_dir DIR] ...

The run directory is ``{output_dir}/{model_tag}`` with a copy of the
config.  Training (``train/loop.py:run_training``) writes
``weights/epoch_{e}_{dev EER}.npz``, ``best.npz`` and ``swa.npz``,
``metrics/dev_score.txt`` and the per-epoch reports, ``metrics.jsonl``,
``metric_log.txt``, ``train_state/`` (which ``--resume`` continues from)
and the final eval's score file and ``t-DCF_EER.txt``; the last line
printed is ``Exp FIN. EER: ..., min t-DCF: ...``.  The model starts from
torch's initialisation under ``--seed``; dev and eval score at the train
batch, or ``eval_batch_size``.  ``--eval`` writes the score file
(``eval_output``), ``t-DCF_EER.txt`` and ``loaded_model_t-DCF_EER.txt``;
its last line is ``DONE. EER: ...%, min t-DCF: ...``; ``--resume`` is
ignored there, as in the JAX package.

The model runs on ``--device`` (default ``cuda``; without a card that
raises, as ``Scorer`` does: pass ``--device cpu``).  Precision and kernels
follow the config, as in the JAX model: ``model_config["dtype"]``
``"bfloat16"`` casts the model for ``--eval``, ``float32`` (the default)
computes in full f32, with cuDNN's and cuBLAS's TF32 turned off for the
run; training keeps f32 weights and runs its steps in bf16 with
``mixed_precision``.  ``use_fused_frontend`` and ``use_fused_stack`` pick
the CUDA kernels of the eval forwards (scoring inside training included;
the train steps run stock ops).  Every architecture of the registry runs
(``configs/*.conf``); ``--eval``'s weights come from
``--eval_model_weights`` or the config's ``model_path``, as the converted
``.npz`` or the reference's ``.pth``.  On a card the ``--eval`` batch is
the serving batch (``SERVING_BATCH_DEFAULTS``); ``eval_batch_size`` and
``eval_chain`` (default 1) in the config override.  ``use_mixup`` and
``adv_training`` in the config turn on the robust-training extras
(``train/loop.py:RobustOptions``).

Data parallelism: on a host with several visible cards, ``main`` without
``WORLD_SIZE`` and with ``--device cuda`` (no index) runs as the JAX CLI
does, data-parallel over the largest number of cards that divides the
config's ``batch_size`` (``data_parallel_ranks``): it prints
``Data-parallel mesh: d devices`` and starts d ranks of the same command
(``parallel/launch.py:spawn``), passing rank 0's output through as it comes
and returning the first failing rank's exit code; when no more than one
card divides the batch it runs in this process on ``cuda:0`` and warns.
``--device cuda:N`` or ``CUDA_VISIBLE_DEVICES`` run on one card.  Under
``torchrun --nproc_per_node N -m aasist_tpu_torch.cli --config C [--eval]``
(``WORLD_SIZE`` above 1) each rank joins the process group
(``parallel/mesh.py:from_env``: NCCL when every rank has a physical card
of its own, else Gloo), owns ``cuda:LOCAL_RANK``
(or the CPU with ``--device cpu``) and decodes only its rows of every
global batch; a train step and the scores equal one process's on the
whole batch.  Rank 0 writes the run directory; every rank reads a
``--resume``.  The eval batch rounds down to a multiple of the world size
(the JAX package's rule).  A train ``batch_size`` (over
``grad_accum_steps`` microbatches) that the world size does not divide
raises, naming the largest world size that does: the JAX package leaves
the spare devices idle instead, but an idle rank would hang every
collective of a process group.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
import warnings
from pathlib import Path

import torch


def default_eval_batch(arch: str, device_type: str, train_bs: int) -> int:
    """The ``--eval`` batch: on a card the serving batch of the
    architecture, on the CPU the train batch, as the JAX package keeps it
    off its accelerator."""
    if device_type != "cuda":
        return train_bs
    from aasist_tpu_torch.serving import SERVING_BATCH_DEFAULTS
    return SERVING_BATCH_DEFAULTS.get(arch, 128)


def check_world(batch_size: int, world: int, grad_accum_steps: int = 1
                ) -> None:
    """Raise unless ``world`` ranks split each of the ``grad_accum_steps``
    microbatches of a train batch evenly, naming the largest world size
    that does."""
    if batch_size % (world * grad_accum_steps):
        fit = max(d for d in range(1, world + 1)
                  if batch_size % (d * grad_accum_steps) == 0)
        raise ValueError(
            f"train batch_size {batch_size} in {grad_accum_steps} "
            f"microbatch(es) does not split over {world} ranks: run "
            f"{fit} ranks (the largest world size up to {world} that "
            "divides it), or change batch_size")


def data_parallel_ranks(batch_size: int, n_cards: int,
                        grad_accum_steps: int = 1) -> int:
    """The ranks a run on ``n_cards`` visible cards takes: the largest
    d <= n_cards that splits each of the ``grad_accum_steps`` microbatches
    of ``batch_size`` (the JAX CLI's mesh over the largest divisor of the
    batch, ``aasist_tpu/cli.py:155-163``)."""
    return max(d for d in range(1, max(n_cards, 1) + 1)
               if batch_size % (d * grad_accum_steps) == 0)


def _spawn_ranks(args, argv) -> "int | None":
    """On a host with several visible cards, without ``WORLD_SIZE`` and with
    ``--device cuda`` (no index): start ``data_parallel_ranks`` ranks of this
    command and return the run's exit code, or, when one rank is all the
    batch allows, warn and return None (the run stays in this process).
    None too where the caller picked a card or a launcher started us."""
    device = torch.device(args.device)
    if ("WORLD_SIZE" in os.environ or device.type != "cuda"
            or device.index is not None or torch.cuda.device_count() < 2):
        return None
    from aasist_tpu_torch.config import load_config

    cfg = load_config(args.config)
    n_cards = torch.cuda.device_count()
    accum = int(cfg.extras.get("grad_accum_steps", 1))
    d = data_parallel_ranks(cfg.batch_size, n_cards, accum)
    if d < 2:
        warnings.warn(
            f"batch_size {cfg.batch_size} does not split over any number "
            f"of the {n_cards} visible cards above one: this run uses "
            f"cuda:0 and leaves {n_cards - 1} idle; pick a batch that "
            "splits, and run torchrun --nproc_per_node N -m "
            "aasist_tpu_torch.cli " + " ".join(argv), stacklevel=2)
        return None
    from aasist_tpu_torch.parallel import launch

    print(f"Data-parallel mesh: {d} devices", flush=True)
    try:
        launch.spawn([sys.executable, "-m", "aasist_tpu_torch.cli", *argv],
                     d, timeout=None, echo=sys.stdout)
    except launch.RanksFailed as e:
        print(e, file=sys.stderr)
        return e.returncode
    return 0


def build_loaders(cfg, device_type: str, seed: int = 1234,
                  eval_only: bool = False, rank: int = 0, world: int = 1):
    """The train, dev and eval batchers and trial metadata
    (``train/loop.py:Loaders``; the JAX package's ``build_loaders``).
    Dev and eval score at the train batch, or ``eval_batch_size``;
    ``eval_only`` builds the eval split alone, at ``default_eval_batch``.
    Train batches are pinned for a card.  With ``world`` > 1 every batcher
    yields ``rank``'s rows; the eval batch rounds down to a multiple of
    ``world`` (at least ``world``), and a train batch that does not split
    raises (``check_world``)."""
    from aasist_tpu_torch.data import dataset as D
    from aasist_tpu_torch.data import protocol as P
    from aasist_tpu_torch.train.loop import Loaders

    n_tr = n_dv = n_ev = None
    if cfg.debug_subset is not None:
        n_tr, n_dv, n_ev = cfg.debug_subset
    eval_entries = P.parse_protocol(cfg.protocol_path("eval"))
    eval_bs = int(cfg.extras.get("eval_batch_size", default_eval_batch(
        cfg.model_config.get("architecture"), device_type, cfg.batch_size)
        if eval_only else cfg.batch_size))
    eval_bs = max(world, eval_bs // world * world)
    shard = {"rank": rank, "world": world}
    ev = D.EvalBatcher(D.AudioStore(cfg.audio_dir("eval")),
                       [e.utt_id for e in eval_entries][:n_ev],
                       batch_size=eval_bs, **shard)
    if eval_only:
        return Loaders(None, None, ev, {}, P.trial_metadata(eval_entries))
    labels, train_files = P.labels_and_files(
        P.parse_protocol(cfg.protocol_path("train")))
    dev_entries = P.parse_protocol(cfg.protocol_path("dev"))
    dcs = cfg.dynamic_chunk
    accum = int(cfg.extras.get("grad_accum_steps", 1))
    check_world(cfg.batch_size, world, accum)
    train = D.TrainBatcher(
        D.AudioStore(cfg.audio_dir("train")), train_files[:n_tr], labels,
        batch_size=cfg.batch_size, seed=seed,
        dcs_buckets=(D.bucket_lengths(dcs.min_samples, dcs.max_samples,
                                      dcs.num_buckets)
                     if dcs.enabled else None),
        dcs_min=dcs.min_samples, dcs_max=dcs.max_samples,
        fixed_len=int(cfg.extras.get("train_fixed_length",
                                     D.FIXED_TRAIN_LEN)),
        pin_memory=device_type == "cuda", groups=accum, **shard)
    dev = D.EvalBatcher(D.AudioStore(cfg.audio_dir("dev")),
                        [e.utt_id for e in dev_entries][:n_dv],
                        batch_size=eval_bs, **shard)
    return Loaders(train, dev, ev, P.trial_metadata(dev_entries),
                   P.trial_metadata(eval_entries))


def load_model_weights(model: torch.nn.Module, model_path) -> None:
    """Fill ``model`` from converted weights (``.npz``) or a reference
    checkpoint (``.pth``, through ``utils/torch_compat.py``); strict both
    ways."""
    model_path = Path(model_path)
    if model_path.suffix == ".npz":
        from aasist_tpu_torch.weights import load_npz
        load_npz(model, model_path)
    elif model_path.suffix == ".pth":
        from aasist_tpu_torch.utils.torch_compat import convert_checkpoint
        convert_checkpoint(model, model_path)
    else:
        raise ValueError(f"unsupported weights format: {model_path.suffix}")


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions and cuBLAS matmuls in full f32 (no TF32), as
    the config asks of an f32 model, restored afterwards."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="ASVspoof detection system (PyTorch / CUDA)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--output_dir", default="./exp_result")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--eval", action="store_true",
                        help="evaluate the configured model and exit")
    parser.add_argument("--comment", default=None)
    parser.add_argument("--eval_model_weights", default=None)
    parser.add_argument("--resume", action="store_true",
                        help="resume training from the saved train state")
    parser.add_argument("--debug_subset", type=int, nargs=3, default=None,
                        metavar=("TRAIN", "DEV", "EVAL"))
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cli: no CUDA device is available; pass --device cpu to run "
            "on the CPU")
    code = _spawn_ranks(args, argv)
    if code is not None:
        return code
    from aasist_tpu_torch.parallel import mesh
    ranks = mesh.from_env(device)
    try:
        return _run(args, ranks)
    finally:
        mesh.shutdown(ranks)


def _run(args, ranks) -> int:
    """``main`` on this process's rank (``ranks.device``)."""
    device = ranks.device
    main = ranks.main

    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.evaluation.metrics import calculate_tdcf_eer
    from aasist_tpu_torch.models.aasist import count_params
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.train.loop import evaluate_to_file, run_training
    from aasist_tpu_torch.utils.seed import set_seed

    cfg = load_config(args.config)
    cfg.seed = args.seed
    if args.debug_subset is not None:
        cfg.debug_subset = tuple(args.debug_subset)
    dtype = cfg.model_config.get("dtype", "float32")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"model_config dtype {dtype!r}: float32 or "
                         "bfloat16")
    if not args.eval and dtype != "float32":
        raise ValueError("training keeps float32 weights: set "
                         "\"mixed_precision\": \"True\" for bf16 steps, "
                         "not model_config dtype bfloat16")
    set_seed(args.seed)

    config_name = Path(args.config).stem
    run_dir = Path(args.output_dir) / cfg.model_tag(
        config_name, args.comment or "")
    if main:
        run_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(args.config, run_dir / "config.conf")
        print(f"Device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})"
                 if device.type == "cuda" else "")
              + (f", rank 0 of {ranks.world}" if ranks.distributed else ""))
    model = build_model(cfg.model_config)
    if main:
        print(f"no. model params: {count_params(model)}")
    loaders = build_loaders(cfg, device.type, args.seed, eval_only=args.eval,
                            rank=ranks.rank, world=ranks.world)
    precision = full_f32 if dtype == "float32" else contextlib.nullcontext

    if not args.eval:
        results = run_training(cfg, model.to(device), loaders, run_dir,
                               seed=args.seed, resume=args.resume,
                               precision=precision, ranks=ranks)
        if main:
            print("Exp FIN. EER: {:.3f}, min t-DCF: {:.5f}".format(
                results["eval_eer"], results["eval_tdcf"]))
        return 0

    weights = args.eval_model_weights or cfg.model_path
    load_model_weights(model, weights)
    model = model.eval().to(device)
    if dtype == "bfloat16":
        model = model.to(torch.bfloat16)
    eval_chain = int(cfg.extras.get("eval_chain", 1))
    if main:
        print(f"Model loaded : {weights}")
        print("Start evaluation...")
    eval_score_path = run_dir / cfg.eval_output
    with precision():
        evaluate_to_file(model, loaders.eval, loaders.eval_trial_meta,
                         eval_score_path, chain=eval_chain, ranks=ranks)
    if ranks.distributed:
        print(f"rank {ranks.rank}: eval batcher {loaders.eval.seconds:.3f} s",
              flush=True)
    if not main:
        return 0
    eer, tdcf = calculate_tdcf_eer(
        eval_score_path, cfg.asv_scores(), run_dir / "t-DCF_EER.txt")
    # the reference writes the report twice on the eval-only path
    calculate_tdcf_eer(eval_score_path, cfg.asv_scores(),
                       run_dir / "loaded_model_t-DCF_EER.txt")
    print(f"DONE. EER: {eer:.3f}%, min t-DCF: {tdcf:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
