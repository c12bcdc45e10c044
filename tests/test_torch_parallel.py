"""Data parallelism in the port, on the CPU (``aasist_tpu_torch/parallel``).

  * the mesh helpers: the idle-device warning, ``pad_batch_to_multiple``
    against the JAX package's, ``local_rows``;
  * ``fused_frontend_sharded`` over ``["cpu", "cpu"]`` against the plain
    version and against the JAX package's ``fused_frontend_sharded`` on its
    8-device CPU mesh (Pallas in interpret mode);
  * the mesh Scorer against the one-device Scorer;
  * two Gloo ranks, each holding half of every batch, against the
    one-process step on the whole batch, float64, two SGD steps, at 1e-10
    on the losses, the parameters and the BatchNorm statistics: tiny AASIST
    with dropout and ``freq_aug`` on, AASIST-Robust (its input noise),
    mixup with PGD, two accumulated microbatches, and a weighted-CCE batch
    whose ranks hold different label mixes;
  * ``cli.main --device cpu`` under two ranks, ``--eval`` and training,
    against one process: the same score files and reports, the run
    directory written once.

The ranks are this file run as a script (``parallel/launch.py:spawn``, the
environment ``torchrun`` sets), each with a 30 s process-group timeout
and a bound on its run, so that a hang fails.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from aasist_tpu_torch import nn  # noqa: E402
from aasist_tpu_torch.config import OptimConfig  # noqa: E402
from aasist_tpu_torch.parallel import launch, mesh  # noqa: E402
from aasist_tpu_torch.registry import build_model  # noqa: E402
from aasist_tpu_torch.train.loop import (RobustOptions,  # noqa: E402
                                         make_train_step)
from aasist_tpu_torch.train.losses import weighted_cce  # noqa: E402
from aasist_tpu_torch.train.optim import (create_optimizer,  # noqa: E402
                                          make_schedule)

TOL = 1e-10
SPAWN_TIMEOUT = 240
_GRAPH = {"gat_dims": [8, 12], "pool_ratios": [0.5, 0.7, 0.5, 0.5],
          "temperatures": [2.0, 2.0, 100.0, 100.0]}
AASIST = {"architecture": "AASIST", "first_conv": 128,
          "filts": [20, [1, 4], [4, 4], [4, 8], [8, 8]], **_GRAPH}
ROBUST = {"architecture": "AASIST_Robust", "first_conv": 128,
          "filts": [20, [1, 4], [4, 4], [4, 8], [8, 8]],
          "gat_dims": [8, 12], "pool_ratios": [0.4, 0.5, 0.7, 0.5],
          "temperatures": [2.0, 2.0, 100.0, 50.0], "noise_sigma": 0.1}
LENGTH = 8000
# name -> (model config, global batch, labels, grad_accum_steps, robust)
VARIANTS = {
    "aasist_dropout_freq_aug": (AASIST, 4, [0, 1, 1, 0], 1, {}),
    "robust_noise": (ROBUST, 4, [1, 0, 0, 1], 1, {}),
    "mixup_pgd": (AASIST, 4, [0, 1, 1, 0], 1,
                  {"use_mixup": True, "adv_training": True,
                   "adv_steps": 2}),
    "grad_accum_2": (AASIST, 8, [0, 1] * 4, 2, {}),
    "label_mix": (AASIST, 8, [1, 1, 1, 0, 0, 0, 0, 0], 1, {}),
}


def _run_steps(name, ranks=None, rows=None):
    """Two SGD steps of variant ``name``: the whole batch (or its ``rows``)
    in one process, or ``ranks``' rows of it.  Returns {name: array} of the
    losses, the parameters and the BatchNorm statistics after."""
    conf, batch, labels, accum, robust = VARIANTS[name]
    torch.manual_seed(0)
    model = build_model(conf).double().train()
    cfg = OptimConfig.from_dict({"optimizer": "sgd", "base_lr": 1e-2,
                                 "scheduler": "none"})
    optimizer = create_optimizer(cfg, model.parameters())
    step = make_train_step(
        model, lambda lg, y, d, ranks=None: weighted_cce(lg, y, ranks=ranks),
        optimizer, make_schedule(cfg), seed=5, freq_aug=True,
        use_duration=False, grad_accum_steps=accum,
        robust=RobustOptions(**robust), ranks=ranks)
    if ranks is not None:
        rows = mesh.local_rows(batch, ranks.rank, ranks.world, accum)
    elif rows is None:
        rows = np.arange(batch)
    out = {}
    for i in range(2):
        rng = np.random.default_rng(40 + i)
        x = torch.from_numpy(rng.standard_normal((batch, LENGTH)) * 0.05)
        y = torch.tensor(labels if i == 0 else labels[::-1])
        d = torch.from_numpy(rng.uniform(1.0, 6.0, batch))
        loss, correct = step(x[rows], y[rows], d[rows], i)
        out[f"loss{i}"] = loss.detach().numpy()
        out[f"correct{i}"] = correct.numpy()
    for k, v in [*model.named_parameters(), *model.named_buffers()]:
        out[k] = v.detach().numpy()
    return out


def _worker(out_dir):
    """One rank: every variant, then its results to ``out_dir``."""
    torch.set_num_threads(1)
    ranks = mesh.from_env("cpu", timeout_s=30)
    try:
        for name in VARIANTS:
            np.savez(Path(out_dir) / f"{name}_{ranks.rank}.npz",
                     **_run_steps(name, ranks))
    finally:
        mesh.shutdown(ranks)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ mesh helpers
def test_make_mesh_warns_on_idle_devices():
    with pytest.warns(UserWarning, match="1 are idle"):
        m = mesh.make_mesh(2, devices=["cpu"] * 3)
    assert m.size == 2 and m.parts(6) == [slice(0, 3), slice(3, 6)]
    with pytest.raises(ValueError, match="does not split"):
        m.parts(5)


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (1, 3)])
def test_pad_batch_to_multiple_is_the_jax_packages(n, multiple):
    from aasist_tpu.parallel.mesh import pad_batch_to_multiple as jax_pad
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, got_n = mesh.pad_batch_to_multiple(x, multiple)
    want, want_n = jax_pad(x, multiple)
    assert got_n == want_n and np.array_equal(got, want)


def test_local_rows_cover_the_batch_once():
    rows = [mesh.local_rows(12, r, 3, groups=2) for r in range(3)]
    assert sorted(np.concatenate(rows).tolist()) == list(range(12))
    # each rank's i-th local microbatch is its share of the global i-th
    assert rows[1].tolist() == [2, 3, 8, 9]
    with pytest.raises(ValueError):
        mesh.local_rows(10, 0, 3)


def test_train_batch_that_does_not_split_names_the_world_to_use():
    from aasist_tpu_torch.cli import check_world
    check_world(24, 4)
    with pytest.raises(ValueError, match="run 4 ranks"):
        check_world(24, 5)
    with pytest.raises(ValueError, match="run 3 ranks"):
        check_world(24, 4, grad_accum_steps=4)


def test_batchers_yield_each_ranks_rows(tmp_path):
    """Each rank's batches are its rows of the one-process batches, the
    train batch's shares of each microbatch in order, the eval batch's
    contiguous share with the last batch's padding; the eval batch rounds
    down to a multiple of the world size."""
    from aasist_tpu_torch import cli
    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.data import synthetic

    synthetic.generate(tmp_path / "LA", n_train=12, n_dev=4, n_eval=10,
                       seed=3, audio_format="wav")
    conf = _cli_conf(tmp_path, tmp_path / "LA", 6)
    cfg = load_config(conf)
    cfg.extras["grad_accum_steps"] = 3
    whole = cli.build_loaders(cfg, "cpu", seed=2)
    parts = [cli.build_loaders(cfg, "cpu", seed=2, rank=r, world=2)
             for r in range(2)]
    for r, part in enumerate(parts):
        rows = mesh.local_rows(6, r, 2, groups=3)
        for (x, y, d), (xr, yr, dr) in zip(whole.train, part.train):
            assert torch.equal(x[rows], xr) and torch.equal(y[rows], yr)
            assert torch.equal(d[rows], dr)
        for (x, ids, n), (xr, ids_r, n_r) in zip(whole.eval, part.eval):
            assert (ids, n) == (ids_r, n_r) and xr.shape[0] == 2
            lo = 2 * r
            assert np.array_equal(xr[:max(0, min(2, n - lo))],
                                  x[lo:min(lo + 2, n)])
    cfg.extras["eval_batch_size"] = 5
    assert cli.build_loaders(cfg, "cpu", eval_only=True, rank=0,
                             world=2).eval.batch_size == 4


# ------------------------------------------------------- sharded frontend
def _frontend_inputs(seed=0, b=8, length=3000):
    from aasist_tpu_torch.models.layers import sinc_filterbank
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, length)) * 0.1).astype(np.float32)
    bank = sinc_filterbank(70, 128).astype(np.float32)
    bn = {"weight": np.float32([1.3]), "bias": np.float32([-0.2]),
          "mean": np.float32([0.05]), "var": np.float32([0.8])}
    return x, bank, bn


def test_fused_frontend_sharded_matches_plain_and_jax():
    from jax.sharding import Mesh

    from aasist_tpu.ops import fused_frontend as jff
    import jax

    from aasist_tpu_torch.ops.fused_frontend import (
        fused_frontend_mesh, fused_frontend_reference, fused_frontend_sharded)

    x, bank, bn = _frontend_inputs()
    t = {k: torch.from_numpy(v) for k, v in bn.items()}
    bn_p = {"weight": t["weight"], "bias": t["bias"]}
    bn_s = {"mean": t["mean"], "var": t["var"]}
    m = mesh.DataMesh(["cpu", "cpu"])
    got = fused_frontend_sharded(torch.from_numpy(x), torch.from_numpy(bank),
                                 bn_p, bn_s, mesh=m)
    plain = fused_frontend_reference(torch.from_numpy(x),
                                     torch.from_numpy(bank), bn_p, bn_s)
    # each part is the plain version of its rows; the whole batch's differs
    # from it by the CPU convolution's order of summation at another batch
    assert torch.equal(got, torch.cat([fused_frontend_reference(
        torch.from_numpy(x[p]), torch.from_numpy(bank), bn_p, bn_s)
        for p in (slice(0, 4), slice(4, 8))]))
    torch.testing.assert_close(got, plain, atol=1e-6, rtol=0)
    assert torch.equal(fused_frontend_mesh(
        torch.from_numpy(x), torch.from_numpy(bank), bn_p, bn_s), plain)
    assert torch.equal(fused_frontend_mesh(
        torch.from_numpy(x), torch.from_numpy(bank), bn_p, bn_s, mesh=m), got)
    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8, 1),
                 ("data", "model"))
    want = np.asarray(jff.fused_frontend_sharded(
        x, bank, {"weight": bn["weight"], "bias": bn["bias"]},
        {"mean": bn["mean"], "var": bn["var"]}, mesh=jmesh))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_mesh_scorer_matches_one_device():
    from aasist_tpu_torch.serving import Scorer

    torch.manual_seed(1)
    model = build_model({**AASIST, "use_fused_frontend": True})
    rng = np.random.default_rng(3)
    waves = [rng.standard_normal(n).astype(np.float32) * 0.1
             for n in (3000, 6400, 9000, 6400, 500)]
    kw = dict(batch_size=4, window=6400, bf16=False, device="cpu")
    one = Scorer(model, **kw)
    two = Scorer(model, mesh=mesh.DataMesh(["cpu", "cpu"]), **kw)
    want = one.score_waveforms(waves)
    np.testing.assert_allclose(two.score_waveforms(waves), want,
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        two.score_waveforms(waves, long_audio=True),
        one.score_waveforms(waves, long_audio=True), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        Scorer(model, mesh=mesh.DataMesh(["cpu"] * 3), **kw)


# ---------------------------------------------------- two ranks, one step
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    launch.spawn([sys.executable, __file__, str(out)], 2,
                 timeout=SPAWN_TIMEOUT, cwd=ROOT)
    return out


@pytest.mark.parametrize("name", list(VARIANTS))
def test_two_ranks_step_is_the_one_process_step(two_ranks, name):
    want = _run_steps(name)
    got = [dict(np.load(two_ranks / f"{name}_{r}.npz")) for r in range(2)]
    assert set(got[0]) == set(want)
    for key, w in want.items():
        for r in range(2):
            err = float(np.max(np.abs(got[r][key] - w), initial=0.0))
            assert err <= TOL * max(1.0, float(np.max(np.abs(w)))), (
                f"{name} rank {r} {key}: max|diff| {err:.3e}")
    assert want["loss0"] != want["loss1"]


def test_per_rank_batch_norm_is_not_the_one_process_step():
    """The check above tells a step whose BatchNorm takes each rank's
    statistics alone: one rank's half batch through the one-process step
    is far from the whole batch's."""
    want = _run_steps("label_mix")
    got = _run_steps("label_mix", rows=mesh.local_rows(8, 0, 2))
    assert abs(float(got["loss0"]) - float(want["loss0"])) > 1e-3
    assert np.abs(got["first_bn.running_mean"]
                  - want["first_bn.running_mean"]).max() > 1e-6


# --------------------------------------------------- the entry point, DP
def _cli_conf(tmp, database, batch):
    conf = json.loads((ROOT / "configs" / "AASIST.conf").read_text())
    conf.update(database_path=str(database), batch_size=batch, num_epochs=2,
                train_fixed_length=16000, eval_batch_size=4)
    conf["model_config"].update(
        filts=[20, [1, 4], [4, 4], [4, 8], [8, 8]], gat_dims=[8, 12],
        use_fused_frontend=True)
    path = tmp / "AASIST.conf"
    path.write_text(json.dumps(conf))
    return path


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """{(mode, world): (run directory, rank 0's output)} for ``--eval`` and
    training under one and two ranks, on one corpus."""
    from aasist_tpu_torch.data import synthetic

    tmp = tmp_path_factory.mktemp("cli")
    synthetic.generate(tmp / "LA", n_train=16, n_dev=6, n_eval=10, seed=21,
                       audio_format="wav")
    conf = _cli_conf(tmp, tmp / "LA", 4)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    base = [sys.executable, "-c",
            "import sys; sys.modules['torch.utils.tensorboard'] = None; "
            "from aasist_tpu_torch import cli; "
            "sys.exit(cli.main(sys.argv[1:]))",
            "--config", str(conf), "--device", "cpu", "--seed", "3"]
    # an untrained model's eval: the train run's first epoch weights
    out = {}
    for world in (1, 2):
        d = tmp / f"train{world}"
        outs = launch.spawn(base + ["--output_dir", str(d)], world,
                            timeout=SPAWN_TIMEOUT, env=env, cwd=ROOT)
        out[("train", world)] = d / "LA_AASIST_ep2_bs4", outs[0]
    weights = out[("train", 1)][0] / "weights" / "swa.npz"
    for world in (1, 2):
        d = tmp / f"eval{world}"
        outs = launch.spawn(base + ["--output_dir", str(d), "--eval",
                                    "--eval_model_weights", str(weights)],
                            world, timeout=SPAWN_TIMEOUT, env=env, cwd=ROOT)
        out[("eval", world)] = d / "LA_AASIST_ep2_bs4", outs[0]
        if world == 2:
            assert all("eval batcher" in o for o in outs), outs
    return out


def _scores(path):
    rows = [line.split() for line in Path(path).read_text().splitlines()]
    return [r[:3] for r in rows], np.array([float(r[3]) for r in rows])


def test_two_rank_eval_is_the_one_process_eval(cli_runs):
    (one, out1), (two, out2) = cli_runs[("eval", 1)], cli_runs[("eval", 2)]
    name = "eval_scores_using_best_dev_model.txt"
    ids1, s1 = _scores(one / name)
    ids2, s2 = _scores(two / name)
    assert ids1 == ids2 and len(ids1) == 10
    np.testing.assert_allclose(s2, s1, atol=1e-6, rtol=0)
    for report in ("t-DCF_EER.txt", "loaded_model_t-DCF_EER.txt"):
        assert (one / report).read_text() == (two / report).read_text()
    assert out1.strip().splitlines()[-1] == out2.strip().splitlines()[-1]


def test_two_rank_training_is_the_one_process_training(cli_runs):
    (one, out1), (two, out2) = cli_runs[("train", 1)], cli_runs[("train", 2)]
    for name in ("metrics/dev_score.txt",
                 "eval_scores_using_best_dev_model.txt"):
        ids1, s1 = _scores(one / name)
        ids2, s2 = _scores(two / name)
        assert ids1 == ids2
        np.testing.assert_allclose(s2, s1, atol=1e-4, rtol=0)
    # the run directory is written once: the same files, the same log lines
    files1 = sorted(p.relative_to(one).as_posix() for p in one.rglob("*"))
    files2 = sorted(p.relative_to(two).as_posix() for p in two.rglob("*"))
    assert files1 == files2
    for log in ("metrics.jsonl", "metric_log.txt"):
        assert (len((one / log).read_text().splitlines())
                == len((two / log).read_text().splitlines()))
    # f32 steps: the two runs' gradients differ by rounding, which Adam's
    # normalised update turns into up to two of its steps (lr 1e-4 each)
    # on a leaf whose gradient is near zero (a conv bias before its
    # BatchNorm), over the 8 steps
    with np.load(one / "weights" / "swa.npz") as a, \
            np.load(two / "weights" / "swa.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], atol=2 * 1e-4 * 8,
                                       rtol=0, err_msg=k)
    last = out1.strip().splitlines()[-1]
    assert last.startswith("Exp FIN.")
    assert out2.strip().splitlines()[-1] == last


if __name__ == "__main__":
    _worker(sys.argv[1])
