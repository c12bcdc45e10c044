"""The training entry point end to end on the CPU:
``cli.main(["--config", C, "--device", "cpu"])`` trains a narrow AASIST
(the stock AASIST.conf with 20 sinc channels and narrow widths,
``use_fused_frontend`` on, whose CPU route is the kernel's plain version)
for two epochs on a 16-utterance synthetic corpus.  It writes the run
directory and the ``Exp FIN.`` line; ``--resume`` after the first epoch
ends bit for bit where the straight run ends; and ``--eval`` of its
``weights/swa.npz`` reproduces the run's final eval scores.
"""

import contextlib
import functools
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from aasist_tpu_torch import cli
from aasist_tpu_torch.data import synthetic
from aasist_tpu_torch.evaluation.scorefile import read_score_file
from aasist_tpu_torch.train import loop

from test_torch_train_models import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TAG = "LA_AASIST_ep2_bs4"


def _conf(tmp, database):
    conf = json.loads((ROOT / "configs" / "AASIST.conf").read_text())
    conf.update(database_path=str(database), batch_size=4, num_epochs=2,
                train_fixed_length=16000, eval_batch_size=4)
    conf["model_config"].update(
        filts=[20, [1, 4], [4, 4], [4, 8], [8, 8]], gat_dims=[8, 12],
        use_fused_frontend=True)
    path = tmp / "AASIST.conf"
    path.write_text(json.dumps(conf))
    return path


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(config, straight run's directory and output, resumed run's)."""
    tmp = tmp_path_factory.mktemp("train")
    synthetic.generate(tmp / "LA", n_train=16, n_dev=8, n_eval=8, seed=21,
                       audio_format="wav")
    conf = _conf(tmp, tmp / "LA")
    with pytest.MonkeyPatch.context() as mp:
        # TensorBoard, where it imports here, pulls in TensorFlow (~13 s)
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        straight = _main(["--config", str(conf), "--device", "cpu",
                          "--output_dir", str(tmp / "a"), "--seed", "3"])
        mp.setattr(loop, "run_training",
                   functools.partial(loop.run_training, max_epochs=1))
        _main(["--config", str(conf), "--device", "cpu",
               "--output_dir", str(tmp / "b"), "--seed", "3"])
        mp.undo()
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        resumed = _main(["--config", str(conf), "--device", "cpu",
                         "--output_dir", str(tmp / "b"), "--seed", "3",
                         "--resume"])
    return conf, (tmp / "a" / TAG, straight), (tmp / "b" / TAG, resumed)


def test_training_writes_the_run_directory(runs):
    _, (run_dir, out), _ = runs
    for name in ("config.conf", "metrics.jsonl", "metric_log.txt",
                 "eval_scores_using_best_dev_model.txt", "t-DCF_EER.txt",
                 "weights/best.npz", "weights/swa.npz",
                 "metrics/dev_score.txt", "metrics/dev_t-DCF_EER_0epo.txt",
                 "metrics/dev_t-DCF_EER_1epo.txt",
                 "train_state/weights.npz", "train_state/opt_state.npz",
                 "train_state/meta.json"):
        assert (run_dir / name).is_file(), name
    assert list((run_dir / "weights").glob("epoch_0_*.npz"))
    meta = json.loads((run_dir / "train_state" / "meta.json").read_text())
    assert (meta["step"], meta["epoch"]) == (8, 1)
    names = {json.loads(line)["name"] for line in
             (run_dir / "metrics.jsonl").read_text().splitlines()}
    loader = {f"loader_{k}" for k in ("rows_ms", "collate_ms", "pin_ms",
                                      "produce_ms")}
    assert {"loss", "train_acc", "lr", "dev_eer", "dev_tdcf",
            "best_dev_eer"} | loader <= names
    ms = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["name"] in loader:
            ms.setdefault(rec["name"], []).append(rec["value"])
    # one value an epoch, the producer's ms a batch by stage
    assert all(len(v) == 2 and min(v) >= 0 for v in ms.values())
    assert min(ms["loader_produce_ms"]) > 0
    losses = [json.loads(line)["value"] for line in
              (run_dir / "metrics.jsonl").read_text().splitlines()
              if json.loads(line)["name"] == "loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    last = out.strip().splitlines()[-1]
    assert last.startswith("Exp FIN. EER: ") and ", min t-DCF: " in last
    assert "epoch 001 batch 0/4" in out


def test_resume_ends_where_the_straight_run_ends(runs):
    _, (a, out_a), (b, out_b) = runs
    assert out_b.strip().splitlines()[-1] == out_a.strip().splitlines()[-1]
    assert "epoch 000" not in out_b and "epoch 001" in out_b
    for name in ("weights/swa.npz", "train_state/weights.npz",
                 "train_state/opt_state.npz", "train_state/swa.npz"):
        with np.load(a / name) as x, np.load(b / name) as y:
            assert x.files == y.files
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], err_msg=name + k)
    assert ((a / "eval_scores_using_best_dev_model.txt").read_text()
            == (b / "eval_scores_using_best_dev_model.txt").read_text())
    assert (json.loads((a / "train_state" / "meta.json").read_text())
            == json.loads((b / "train_state" / "meta.json").read_text()))


def test_eval_of_the_swa_weights_reproduces_the_final_scores(runs, tmp_path):
    conf, (run_dir, _), _ = runs
    out = _main(["--config", str(conf), "--device", "cpu", "--eval",
                 "--eval_model_weights", str(run_dir / "weights/swa.npz"),
                 "--output_dir", str(tmp_path)])
    assert out.strip().splitlines()[-1].startswith("DONE. EER: ")
    name = "eval_scores_using_best_dev_model.txt"
    got = read_score_file(tmp_path / TAG / name)
    want = read_score_file(run_dir / name)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    np.testing.assert_allclose([r[3] for r in got], [r[3] for r in want],
                               atol=1e-6, rtol=0)


# each stock config's model_config narrowed (every other key as shipped:
# loss, freq_aug, DCS, optimizer, mixed_precision)
NARROW = {
    "AASIST": {"filts": [20, [1, 4], [4, 4], [4, 8], [8, 8]],
               "gat_dims": [8, 12]},
    "AASIST-L": {"filts": [20, [1, 4], [4, 4], [4, 8], [8, 8]],
                 "gat_dims": [8, 12]},
    "AASIST_tpu_fast": {"filts": [20, [1, 4], [4, 4], [4, 8], [8, 8]],
                        "gat_dims": [8, 12]},
    "AASIST2": {"filts": [20, [1, 16], [16, 16], [16, 16], [16, 16]],
                "gat_dims": [8, 12], "spk_emb_dim": 8},
    "AASIST-Robust": {"filts": [20, [1, 4], [4, 4], [4, 8], [8, 8]],
                      "gat_dims": [8, 12]},
    "RawGATST_baseline": {"filts": [70, [1, 4], [4, 4], [4, 8], [8, 8]]},
    "RawNet2_baseline": {"filts": [20, [20, 20], [20, 16], [16, 16]],
                         "gru_node": 16, "nb_gru_layer": 1,
                         "nb_fc_node": 16, "first_conv": 128},
}


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    synthetic.generate(root / "LA", n_train=4, n_dev=4, n_eval=4, seed=3,
                       audio_format="wav")
    return root


@pytest.mark.parametrize("name", sorted(NARROW))
def test_every_stock_config_trains(name, tiny_corpus, monkeypatch):
    """One epoch of two steps of each stock config at narrow width, its
    own loss, freq_aug, DCS windows (16,000 samples at most here),
    optimizer and precision.  RawGAT-ST's projections fix its input at
    64,600 samples: the default 96,000-sample train window raises, as the
    JAX package's crashes, and ``train_fixed_length`` 64600 trains."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    conf = json.loads((ROOT / "configs" / f"{name}.conf").read_text())
    conf.update(database_path=str(tiny_corpus / "LA"), batch_size=2,
                num_epochs=1, eval_all_best="False")
    if "dynamic_chunk" in conf:
        conf["dynamic_chunk"].update(min_samples=8000, max_samples=16000,
                                     num_buckets=3)
    conf["model_config"].update(NARROW[name])
    path = tiny_corpus / f"{name}.conf"
    argv = ["--config", str(path), "--device", "cpu", "--output_dir",
            str(tiny_corpus / "exp")]
    if name == "RawGATST_baseline":
        path.write_text(json.dumps(conf))
        with pytest.raises(ValueError, match="train_fixed_length"):
            _main(argv)
        conf["train_fixed_length"] = 64600
    else:
        conf["train_fixed_length"] = 16000
    path.write_text(json.dumps(conf))
    assert _main(argv).strip().splitlines()[-1].startswith("Exp FIN. EER:")
