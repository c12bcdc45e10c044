"""A host with several cards, on the CPU: the process group's backend by
physical card (``parallel/mesh.py:choose_backend``, ``initialize_multihost``),
``cli.main``'s data-parallel start on a multi-card host with the cards
and the launcher stood in for, and ``parallel/launch.py:spawn`` passing
rank 0's output through as it comes and a failing rank's exit code back;
``torchrun`` starting two CPU ranks of ``cli.main``.
"""

import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from aasist_tpu_torch import cli
from aasist_tpu_torch.parallel import launch, mesh


# ------------------------------------------------- the backend decision
@pytest.mark.parametrize("cards,want", [
    (["GPU-a", "GPU-b"], "nccl"),
    (["GPU-a", "GPU-b", "GPU-c", "GPU-d"], "nccl"),
    (["GPU-a"], "nccl"),
    (["GPU-a", "GPU-a"], "gloo"),
    (["GPU-a", "GPU-b", "GPU-a"], "gloo"),
    ([None, None], "gloo"),
    (["GPU-a", None], "gloo"),
    ([], "gloo"),
], ids=["two cards", "four cards", "one card", "two ranks on one card",
        "a card shared of three", "the CPU", "a rank on the CPU", "none"])
def test_choose_backend_by_physical_card(cards, want):
    """NCCL when every rank holds a card of its own, by UUID; Gloo where
    two ranks share one or a rank runs on the CPU.  The count of visible
    cards plays no part: a launcher that shows each rank only its own card
    (CUDA_VISIBLE_DEVICES per rank) still gets NCCL."""
    assert mesh.choose_backend(cards) == want


def test_card_uuid_is_none_on_the_cpu():
    assert mesh.card_uuid(torch.device("cpu")) is None


@pytest.fixture
def fake_group(monkeypatch):
    """``init_process_group`` recorded, not run; the store is a real
    one-rank TCPStore on localhost."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    return calls


@pytest.mark.parametrize("backend,want", [(None, "gloo"), ("gloo", "gloo"),
                                          ("nccl", "nccl")])
def test_initialize_multihost_takes_an_explicit_backend_as_given(
        fake_group, backend, want):
    """Without ``backend`` the ranks' cards decide (the CPU: Gloo); an
    explicit one is taken as it is, even where the cards would pick
    another."""
    port = launch.free_port()
    ranks = mesh.initialize_multihost(f"localhost:{port}", 1, 0,
                                      device="cpu", backend=backend,
                                      timeout_s=10)
    assert [b for b, _ in fake_group] == [want]
    kw = fake_group[0][1]
    assert kw["world_size"] == 1 and kw["rank"] == 0
    assert isinstance(kw["store"], torch.distributed.Store)
    assert ranks.distributed and ranks.device == torch.device("cpu")


def test_initialize_multihost_gathers_the_cards_through_the_store(
        fake_group, monkeypatch):
    """Each rank writes its card's UUID into the store and every rank
    decides on the same gathered list: one rank's card alone is NCCL."""
    monkeypatch.setattr(mesh, "card_uuid", lambda device: "GPU-only")
    port = launch.free_port()
    mesh.initialize_multihost(f"localhost:{port}", 1, 0, device="cpu",
                              timeout_s=10)
    backend, kw = fake_group[0]
    assert backend == "nccl"
    store = kw["store"].underlying_store
    assert store.get(f"{mesh.CARD_KEY}/0") == b"GPU-only"


def test_torchrun_eval_on_two_cpu_ranks(tmp_path):
    """``torchrun --nproc_per_node 2 -m aasist_tpu_torch.cli --eval`` on the
    CPU: torchrun's agent already serves the store on MASTER_PORT, and the
    ranks join it (``initialize_multihost`` through torch's rendezvous),
    pick Gloo and score the corpus as one process does."""
    import numpy as np

    from aasist_tpu_torch.data import synthetic
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.weights import save_npz

    root = Path(__file__).resolve().parents[1]
    synthetic.generate(tmp_path / "LA", n_train=2, n_dev=2, n_eval=8,
                       seed=21, audio_format="wav")
    conf = json.loads((root / "configs" / "AASIST.conf").read_text())
    conf.update(database_path=str(tmp_path / "LA"), batch_size=4,
                eval_batch_size=4)
    conf["model_config"].update(filts=[20, [1, 4], [4, 4], [4, 8], [8, 8]],
                                gat_dims=[8, 12])
    conf_path = tmp_path / "tiny.conf"
    conf_path.write_text(json.dumps(conf))
    torch.manual_seed(0)
    weights = tmp_path / "w.npz"
    save_npz(build_model(conf["model_config"]), weights)
    args = ["--config", str(conf_path), "--device", "cpu", "--eval",
            "--eval_model_weights", str(weights)]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(launch.free_port()), "-m",
         "aasist_tpu_torch.cli", *args, "--output_dir",
         str(tmp_path / "two")],
        env=env, cwd=root, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    assert cli.main(args + ["--output_dir", str(tmp_path / "one")]) == 0

    def scores(d):
        path, = d.rglob("eval_scores_using_best_dev_model.txt")
        rows = [ln.split() for ln in path.read_text().splitlines()]
        return [r[0] for r in rows], np.array([float(r[3]) for r in rows])

    ids2, s2 = scores(tmp_path / "two")
    ids1, s1 = scores(tmp_path / "one")
    assert ids2 == ids1 and len(ids1) == 8
    np.testing.assert_allclose(s2, s1, atol=1e-6, rtol=0)


# ----------------------------------------------- cli.main on many cards
def _config(tmp_path, batch_size):
    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / "AASIST.conf").read_text())
    cfg["batch_size"] = batch_size
    path = tmp_path / f"b{batch_size}.conf"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture
def four_cards(monkeypatch):
    """Four visible cards and no launcher: ``spawn`` and the run itself
    are recorded, not run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    seen = {"spawn": [], "run": []}

    def spawn(argv, nproc, **kw):
        seen["spawn"].append((list(argv), nproc, kw))
        return [""] * nproc

    monkeypatch.setattr(launch, "spawn", spawn)
    monkeypatch.setattr(cli, "_run",
                        lambda args, ranks: seen["run"].append(ranks) or 0)
    return seen


@pytest.mark.parametrize("batch,ranks", [(24, 4), (6, 3), (8, 4), (9, 3),
                                         (2, 2)])
def test_cli_spawns_the_largest_divisor_of_the_batch(
        tmp_path, four_cards, capsys, batch, ranks):
    """As the JAX CLI: data-parallel over the largest number of cards that
    divides the batch, the same command on every rank, rank 0's output
    passed through."""
    argv = ["--config", _config(tmp_path, batch), "--eval"]
    assert cli.main(argv) == 0
    (cmd, nproc, kw), = four_cards["spawn"]
    assert nproc == ranks
    assert cmd == [sys.executable, "-m", "aasist_tpu_torch.cli", *argv]
    assert kw["echo"] is sys.stdout and kw["timeout"] is None
    assert not four_cards["run"]
    assert f"Data-parallel mesh: {ranks} devices" in capsys.readouterr().out


def test_cli_warns_and_runs_one_process_when_no_split_fits(
        tmp_path, four_cards):
    argv = ["--config", _config(tmp_path, 7)]
    with pytest.warns(UserWarning, match="torchrun --nproc_per_node"):
        assert cli.main(argv) == 0
    assert not four_cards["spawn"]
    ranks, = four_cards["run"]
    assert not ranks.distributed and ranks.device == torch.device("cuda")


@pytest.mark.parametrize("how", ["--device cuda:0", "WORLD_SIZE",
                                 "--device cpu"])
def test_cli_spawns_nothing_where_a_card_or_launcher_is_given(
        tmp_path, four_cards, monkeypatch, how):
    argv = ["--config", _config(tmp_path, 24)]
    if how == "WORLD_SIZE":
        monkeypatch.setenv("WORLD_SIZE", "1")
    else:
        argv += how.split()
    assert cli.main(argv) == 0
    assert not four_cards["spawn"]
    ranks, = four_cards["run"]
    assert not ranks.distributed


def test_cli_returns_a_failing_ranks_exit_code(tmp_path, four_cards,
                                               monkeypatch, capsys):
    def failing(argv, nproc, **kw):
        raise launch.RanksFailed("rank 1 exited 3", 3, ["", "boom"])

    monkeypatch.setattr(launch, "spawn", failing)
    assert cli.main(["--config", _config(tmp_path, 24)]) == 3
    assert "rank 1 exited 3" in capsys.readouterr().err


def test_one_card_runs_in_this_process(tmp_path, four_cards, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["--config", _config(tmp_path, 24)]) == 0
    assert not four_cards["spawn"] and len(four_cards["run"]) == 1


@pytest.mark.parametrize("batch,cards,accum,want", [
    (24, 4, 1, 4), (6, 4, 1, 3), (7, 4, 1, 1), (24, 8, 1, 8),
    (24, 8, 2, 6), (24, 5, 2, 4), (24, 1, 1, 1)])
def test_data_parallel_ranks(batch, cards, accum, want):
    assert cli.data_parallel_ranks(batch, cards, accum) == want


# ------------------------------------------------------------ spawn
_RANK = textwrap.dedent("""
    import os, sys, time
    rank = int(os.environ["RANK"])
    for i in range(3):
        print(f"rank {rank} line {i}", flush=True)
        time.sleep(0.05)
    sys.exit(int(sys.argv[1]) if rank == 1 else 0)
""")


def test_spawn_echoes_rank_0_and_returns_every_output():
    echo = io.StringIO()
    outs = launch.spawn([sys.executable, "-c", _RANK, "0"], 2, timeout=60,
                        echo=echo)
    assert echo.getvalue().splitlines() == [f"rank 0 line {i}"
                                            for i in range(3)]
    assert [o.splitlines()[-1] for o in outs] == ["rank 0 line 2",
                                                  "rank 1 line 2"]


def test_spawn_raises_with_the_failing_ranks_exit_code():
    with pytest.raises(launch.RanksFailed, match="rank 1 exited 5") as e:
        launch.spawn([sys.executable, "-c", _RANK, "5"], 2, timeout=60)
    assert e.value.returncode == 5
    assert "rank 1 line 2" in e.value.outputs[1]


def test_spawn_kills_every_rank_after_its_timeout():
    slow = "import time; time.sleep(30)"
    with pytest.raises(launch.RanksFailed, match="timed out") as e:
        launch.spawn([sys.executable, "-c", slow], 2, timeout=1)
    assert e.value.returncode == 1
