"""The port's eval pipeline and ``--eval`` entry point, on the CPU.

``produce_scores`` against the JAX package's on a small model with the same
weights, chained and pipelined; the whole pipeline (FLAC decode, batcher,
forward, score file, metrics) through ``cli.main`` on the seed-77 corpus
with the pretrained AASIST in f32, held to the e2e golden at the gates of
``tests/test_e2e_differential.py``; the entry point's refusals, its
training branch and ``--resume`` beside ``--eval``.
"""

import contextlib
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from aasist_tpu.config import load_config as jax_load_config
from aasist_tpu.registry import build_model as jax_build_model
from aasist_tpu.train import loop as jax_loop

from aasist_tpu_torch import cli
from aasist_tpu_torch.config import load_config
from aasist_tpu_torch.data import synthetic
from aasist_tpu_torch.data.dataset import AudioStore, pad_to_fixed
from aasist_tpu_torch.evaluation.metrics import calculate_tdcf_eer
from aasist_tpu_torch.evaluation.scorefile import read_score_file
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.train.loop import make_eval_step, produce_scores
from aasist_tpu_torch.weights import load_jax_params, load_npz, save_npz

ROOT = Path(__file__).resolve().parent.parent
GOLDENS = ROOT / "tests" / "goldens"

SMALL_CONF = {
    "architecture": "AASIST",
    "first_conv": 128,
    "filts": [70, [1, 8], [8, 8], [8, 12], [12, 12]],
    "gat_dims": [12, 16],
    "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}
WINDOW, BATCH, N_UTTS = 16000, 2, 9       # 5 batches, the last of 1 row


class _Batcher:
    """(x (BATCH, WINDOW), utt_ids, n_real) over N_UTTS seeded rows, the
    last batch padded by repeating its last row, as EvalBatcher yields."""

    def __init__(self):
        rng = np.random.default_rng(31)
        self.rows = (rng.standard_normal((N_UTTS, WINDOW)) * 0.05
                     ).astype(np.float32)
        self.utt_ids = [f"u{i:03d}" for i in range(N_UTTS)]
        self.batch_size = BATCH

    def __iter__(self):
        for i in range(0, N_UTTS, BATCH):
            x = self.rows[i:i + BATCH]
            n = len(x)
            x = np.concatenate([x, np.repeat(x[-1:], BATCH - n, 0)])
            yield x, self.utt_ids[i:i + BATCH], n


@pytest.fixture(scope="module")
def small():
    """(JAX model, params, state, port model with the same weights)."""
    jm = jax_build_model(SMALL_CONF)
    params, state = jm.init(jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), t)
    params, state = to_np(params), to_np(state)
    rng = np.random.default_rng(11)
    for bs in state["encoder"]:          # BatchNorm off its init
        for bn in bs.values():
            bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(
                np.float32)
    return jm, params, state, load_jax_params(build_model(SMALL_CONF),
                                              params, state)


@pytest.fixture(scope="module")
def jax_scores(small):
    """chain -> the JAX package's produce_scores at that chain, its step
    jitted once a chain length."""
    jm, params, state, _ = small
    cache = {}

    def get(chain):
        if chain not in cache:
            step = (jax_loop.make_chained_eval_step(jm, chain) if chain > 1
                    else jax_loop.make_eval_step(jm))
            cache[chain] = jax_loop.produce_scores(
                jm, params, state, _Batcher(), eval_step=step, chain=chain)
        return cache[chain]

    return get


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("chain", [1, 2, 3])
def test_produce_scores_matches_the_jax_package(small, jax_scores, chain,
                                                depth):
    """Chains of 2 and 3 over 5 batches end in a partial group padded with
    its last batch; every real utterance is scored once, in order."""
    want_ids, want = jax_scores(chain)
    ids, scores = produce_scores(small[3], _Batcher(), pipeline_depth=depth,
                                 chain=chain)
    assert ids == want_ids == _Batcher().utt_ids
    np.testing.assert_allclose(scores, want, rtol=0, atol=1e-5)


def test_a_step_that_is_not_chained_raises(small):
    tm = small[3]
    with pytest.raises(ValueError, match="calling it failed"):
        produce_scores(tm, _Batcher(), eval_step=make_eval_step(tm),
                       chain=2)
    with pytest.raises(ValueError, match=r"returned shape \(2, 2\)"):
        produce_scores(tm, _Batcher(), eval_step=lambda xs: tm(xs[0])[1],
                       chain=2)


def test_eval_keys_are_the_jax_packages():
    """The keys the eval path reads, from every stock config."""
    for path in sorted((ROOT / "configs").glob("*.conf")):
        got, want = load_config(path), jax_load_config(path)
        for key in ("model_path", "database_path", "asv_score_path",
                    "eval_output", "batch_size", "num_epochs", "track"):
            assert getattr(got, key) == getattr(want, key), (path, key)
        assert got.model_tag(path.stem, "x") == want.model_tag(path.stem,
                                                               "x")
        for split in ("train", "dev", "eval"):
            assert got.protocol_path(split) == want.protocol_path(split)
            assert got.audio_dir(split) == want.audio_dir(split)
        assert got.asv_scores() == want.asv_scores()
        assert got.extras.get("eval_chain") == want.extras.get("eval_chain")


def test_eval_batch_defaults():
    assert cli.default_eval_batch("AASIST", "cuda", 24) == 128
    assert cli.default_eval_batch("AASIST", "cpu", 24) == 24


def _conf(tmp, database, **model_keys):
    conf = json.loads((ROOT / "configs" / "AASIST.conf").read_text())
    conf.update(database_path=str(database),
                model_path=str(ROOT / "checkpoints" / "AASIST.npz"),
                eval_batch_size=8)
    conf["model_config"].update(model_keys)
    path = tmp / "AASIST.conf"
    path.write_text(json.dumps(conf))
    return path


def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def cli77(tmp_path_factory):
    """``cli.main --eval --device cpu`` over the seed-77 corpus (4/4/48,
    FLAC) with the pretrained AASIST in f32: (run dir, stdout, asv file)."""
    tmp = tmp_path_factory.mktemp("cli77")
    synthetic.generate(tmp / "LA", n_train=4, n_dev=4, n_eval=48, seed=77)
    conf = _conf(tmp, tmp / "LA")
    rc, out = _run_cli(["--config", str(conf), "--eval", "--device", "cpu",
                        "--output_dir", str(tmp / "exp")])
    assert rc == 0
    run_dir = tmp / "exp" / "LA_AASIST_ep100_bs24"
    return run_dir, out, load_config(conf).asv_scores()


def test_cli_eval_reproduces_the_e2e_golden(cli77):
    """Scores within 1e-4 of the torch reference's, the same ranking, and
    EER / min t-DCF within 1e-10 of the golden's."""
    run_dir, _, asv = cli77
    golden = np.load(GOLDENS / "e2e_differential_golden.npz")
    rows = read_score_file(run_dir / "eval_scores_using_best_dev_model.txt")
    assert [r[0] for r in rows] == [str(u) for u in golden["utt_ids"]]
    scores = np.asarray([r[3] for r in rows])
    ref = np.asarray(golden["scores"], np.float64)
    assert np.abs(scores - ref).max() < 1e-4
    np.testing.assert_array_equal(np.argsort(scores), np.argsort(ref))
    eer, tdcf = calculate_tdcf_eer(
        run_dir / "eval_scores_using_best_dev_model.txt", asv,
        printout=False)
    assert eer == pytest.approx(float(golden["eer"]), abs=1e-10)
    assert tdcf == pytest.approx(float(golden["min_tdcf"]), abs=1e-10)


def test_cli_writes_the_run_directory(cli77):
    """The copied config, both reports (the same text), and a last line
    whose numbers are the reports'."""
    run_dir, out, _ = cli77
    golden = np.load(GOLDENS / "e2e_differential_golden.npz")
    assert json.loads((run_dir / "config.conf").read_text())[
        "model_config"]["architecture"] == "AASIST"
    report = (run_dir / "t-DCF_EER.txt").read_text()
    assert (run_dir / "loaded_model_t-DCF_EER.txt").read_text() == report
    eer = float(re.search(r"\tEER\t\t= +([0-9.]+) %", report).group(1))
    tdcf = float(re.search(r"min-tDCF\t\t= +([0-9.]+)", report).group(1))
    assert eer == pytest.approx(float(golden["eer"]), abs=1e-8)
    assert tdcf == pytest.approx(float(golden["min_tdcf"]), abs=1e-8)
    last = out.strip().splitlines()[-1]
    assert last == f"DONE. EER: {eer:.3f}%, min t-DCF: {tdcf:.5f}"


def test_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    conf = _conf(tmp_path, tmp_path / "LA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", str(conf), "--eval",
                  "--output_dir", str(tmp_path / "exp")])
    assert not (tmp_path / "exp").exists()


def test_cli_trains_without_eval(tmp_path, monkeypatch):
    """Without ``--eval`` the entry point trains (one epoch of a narrow
    AASIST here; tests/test_torch_train_cli.py holds the run)."""
    # TensorBoard, where it imports here, pulls in TensorFlow (~13 s)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    synthetic.generate(tmp_path / "LA", n_train=4, n_dev=4, n_eval=4,
                       seed=5, audio_format="wav")
    conf = json.loads(_conf(tmp_path, tmp_path / "LA").read_text())
    conf.update(num_epochs=1, batch_size=2, train_fixed_length=16000,
                eval_all_best="False")
    conf["model_config"].update(SMALL_CONF)
    (tmp_path / "AASIST.conf").write_text(json.dumps(conf))
    rc, out = _run_cli(["--config", str(tmp_path / "AASIST.conf"),
                        "--device", "cpu", "--output_dir",
                        str(tmp_path / "exp")])
    assert rc == 0
    assert out.strip().splitlines()[-1].startswith("Exp FIN. EER: ")
    run_dir = tmp_path / "exp" / "LA_AASIST_ep1_bs2"
    assert json.loads((run_dir / "train_state" / "meta.json").read_text())[
        "step"] == 2
    assert (run_dir / "weights" / "swa.npz").is_file()


def test_cli_eval_ignores_resume(tmp_path):
    """``--eval --resume`` scores as ``--eval`` does and trains nothing,
    as the JAX package's entry point."""
    synthetic.generate(tmp_path / "LA", n_train=2, n_dev=2, n_eval=4,
                       seed=6, audio_format="wav")
    conf = json.loads(_conf(tmp_path, tmp_path / "LA").read_text())
    conf["model_config"].update(SMALL_CONF)
    conf["model_path"] = str(tmp_path / "small.npz")
    save_npz(build_model(SMALL_CONF), tmp_path / "small.npz")
    (tmp_path / "AASIST.conf").write_text(json.dumps(conf))
    conf = tmp_path / "AASIST.conf"
    outs = []
    for extra in ([], ["--resume"]):
        rc, out = _run_cli(["--config", str(conf), "--eval", "--device",
                            "cpu", "--output_dir",
                            str(tmp_path / f"exp{len(extra)}")] + extra)
        assert rc == 0
        outs.append(out.strip().splitlines()[-1])
    assert outs[0] == outs[1] and outs[1].startswith("DONE. EER: ")
    run_dir = tmp_path / "exp1" / "LA_AASIST_ep100_bs24"
    assert not (run_dir / "train_state").exists()
    assert ((run_dir / "eval_scores_using_best_dev_model.txt").read_text()
            == (tmp_path / "exp0" / "LA_AASIST_ep100_bs24"
                / "eval_scores_using_best_dev_model.txt").read_text())


def test_only_converted_weights_load(tmp_path):
    """Converted .npz and reference .pth checkpoints load (the .pth through
    utils/torch_compat.py, tests/test_torch_torch_compat.py); any other
    suffix raises."""
    model = build_model(SMALL_CONF)
    torch.save(model.state_dict(), tmp_path / "AASIST.pth")
    other = build_model(SMALL_CONF)
    cli.load_model_weights(other, tmp_path / "AASIST.pth")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported"):
        cli.load_model_weights(model, tmp_path / "AASIST.ckpt")


def _pretrained(dtype=torch.float32):
    model = build_model(load_config(ROOT / "configs" / "AASIST.conf")
                        .model_config)
    return load_npz(model, ROOT / "checkpoints" / "AASIST.npz").to(dtype)


@pytest.fixture(scope="module")
def corpus99(tmp_path_factory):
    """The seed-99 corpus of e2e_diff_big_*.npz (2/2/512 utterances, WAV):
    (root, its eval utterances in the protocol's order)."""
    root = tmp_path_factory.mktemp("la99") / "LA"
    synthetic.generate(root, n_train=2, n_dev=2, n_eval=512, seed=99,
                       audio_format="wav")
    golden = np.load(GOLDENS / "e2e_diff_big_AASIST.npz")
    store = AudioStore(root / "ASVspoof2019_LA_eval")
    return root, [pad_to_fixed(store.read(str(u))).astype(np.float32)
                  for u in golden["utt_ids"]]


def _chip_smoke():
    """chip_smoke.py as a module (its top level imports the standard
    library only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_512_goldens_utterance_77_is_a_node_order_tie(corpus99,
                                                          monkeypatch):
    """e2e_diff_big_AASIST.npz's LA_E_9900077 turns on a near-tie inside
    the model: pool_hS1's 3rd and 4th kept nodes score less than 1e-6
    apart in float64, and the two branches are joined by an element-wise
    max over nodes in rank order.  The JAX package and the port read the
    same f32 score there, chip_smoke.py's NODE_ORDER_TIES value, 7.1e-3
    off the golden; the port's float64 forward with that pair's order
    swapped gives the golden's score."""
    from aasist_tpu.train.checkpoints import load_weights

    golden = np.load(GOLDENS / "e2e_diff_big_AASIST.npz")
    i = [str(u) for u in golden["utt_ids"]].index("LA_E_9900077")
    x = corpus99[1][i][None]
    jm = jax_build_model(jax_load_config(ROOT / "configs" / "AASIST.conf")
                         .model_config)
    params, state = load_weights(ROOT / "checkpoints" / "AASIST.npz")
    j32 = float(jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False)[0][
        1])(params, state, x)[0, 1])
    model = _pretrained()
    with torch.inference_mode():
        t32 = float(model(torch.from_numpy(x))[1][0, 1])
    other = _chip_smoke().NODE_ORDER_TIES["LA99"]["LA_E_9900077"]
    print(f"golden {golden['scores'][i]:.7f}, JAX f32 {j32:.7f}, port f32 "
          f"{t32:.7f}, NODE_ORDER_TIES {other}")
    assert abs(t32 - j32) < 1e-5 and abs(j32 - other) < 1e-5
    assert abs(j32 - golden["scores"][i]) > 5e-3

    model = model.double()
    pool = model.pool_hS1
    kept = []

    def swapped(h, rngs=None):      # the pool's forward takes the stream
        s = torch.sigmoid(pool.proj(h))[..., 0]
        n_keep = max(int(h.shape[1] * pool.k), 1)
        idx = torch.topk(s, n_keep, dim=1, sorted=True)
        kept.append(idx.values[0].numpy())
        idx = idx.indices[:, [0, 1, 3, 2, 4]]
        h = h * s[..., None]
        return torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))

    cuts = {}

    def cut_gap(name):
        def hook(mod, args, out):
            s = torch.sort(torch.sigmoid(mod.proj(args[0]))[0, :, 0],
                           descending=True).values
            n_keep = max(int(len(s) * mod.k), 1)
            cuts[name] = float(s[n_keep - 1] - s[n_keep])
        return hook

    for name, mod in model.named_modules():
        if name.startswith("pool_") and "." not in name:
            mod.register_forward_hook(cut_gap(name))
    monkeypatch.setattr(pool, "forward", swapped)
    with torch.inference_mode():
        t64 = float(model(torch.from_numpy(x).double())[1][0, 1])
    print(f"pool_hS1 kept scores {kept[0]}, swapped float64 {t64:.7f}; "
          f"score gaps at each pool's top-k cut {cuts}")
    assert len(kept[0]) == 5 and kept[0][2] - kept[0][3] < 1e-6
    assert len(cuts) == 6 and min(cuts.values()) > 1e-4
    assert abs(t64 - golden["scores"][i]) < 1e-5


@pytest.mark.slow
def test_cli_eval_reproduces_the_512_utterance_golden(corpus99, tmp_path):
    """The seed-99 corpus against e2e_diff_big_AASIST.npz: scores within
    1e-4, the ranking equal but for pairs whose reference scores lie within
    2e-4 (the tie rule of tools/verify_reference_parity.py), EER / min
    t-DCF within 1e-10.  The row of chip_smoke.py's NODE_ORDER_TIES is
    held at 1e-4 to the golden or to the JAX package's reading of the other
    node order (as in chip_smoke.py phase 6), every other row to the
    golden."""
    root, _ = corpus99
    conf = _conf(tmp_path, root)
    rc, _ = _run_cli(["--config", str(conf), "--eval", "--device", "cpu",
                      "--output_dir", str(tmp_path / "exp")])
    assert rc == 0
    run_dir = tmp_path / "exp" / "LA_AASIST_ep100_bs24"
    golden = np.load(GOLDENS / "e2e_diff_big_AASIST.npz")
    got = read_score_file(run_dir / "eval_scores_using_best_dev_model.txt")
    assert [r[0] for r in got] == [str(u) for u in golden["utt_ids"]]
    scores = np.asarray([r[3] for r in got])
    ref = np.asarray(golden["scores"], np.float64)
    ids = [str(u) for u in golden["utt_ids"]]
    for utt, other in _chip_smoke().NODE_ORDER_TIES["LA99"].items():
        i = ids.index(utt)
        if abs(scores[i] - other) < abs(scores[i] - ref[i]):
            ref[i] = other
    assert np.abs(scores - ref).max() < 1e-4
    order, ref_order = np.argsort(scores), np.argsort(ref)
    swaps = order != ref_order
    assert np.all(np.abs(ref[order[swaps]] - ref[ref_order[swaps]]) < 2e-4)
    eer, tdcf = calculate_tdcf_eer(
        run_dir / "eval_scores_using_best_dev_model.txt",
        load_config(conf).asv_scores(), printout=False)
    assert eer == pytest.approx(float(golden["eer"]), abs=1e-10)
    assert tdcf == pytest.approx(float(golden["min_tdcf"]), abs=1e-10)


@pytest.mark.slow
def test_bf16_drift_is_the_jax_packages(corpus99):
    """The bf16 forward (the whole model cast, as the JAX Scorer casts it)
    against the f32 one, in the port and in the JAX package, on the seed-99
    utterances whose bf16 scores drift most on the card (chip_smoke.py
    phase 6): both stay within chip_smoke.py's BF16_EVAL_REL (5 % of
    max(|f32|, 2)), and the port's drift is of the JAX package's order."""
    from aasist_tpu.nn import with_compute_dtype
    from aasist_tpu.train.checkpoints import load_weights

    import jax.numpy as jnp

    _, rows = corpus99
    x = np.stack([rows[i] for i in (188, 203, 237, 257, 363, 499)])
    jm = jax_build_model(load_config(ROOT / "configs" / "AASIST.conf")
                         .model_config)
    params, state = load_weights(ROOT / "checkpoints" / "AASIST.npz")
    fwd = jax.jit(lambda m, p, s, x: m.apply(p, s, x, train=False)[0][1],
                  static_argnums=0)
    cast = lambda t: jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, t)
    j32 = np.asarray(fwd(jm, params, state, x))[:, 1]
    j16 = np.asarray(fwd(with_compute_dtype(jm, jnp.bfloat16), cast(params),
                         cast(state), x).astype(jnp.float32))[:, 1]
    with torch.inference_mode():
        t32 = _pretrained()(torch.from_numpy(x))[1][:, 1].numpy()
        t16 = _pretrained(torch.bfloat16)(torch.from_numpy(x))[1][
            :, 1].float().numpy()
    np.testing.assert_allclose(t32, j32, rtol=0, atol=1e-4)
    scale = np.maximum(np.abs(j32), 2.0)
    jax_rel = np.abs(j16 - j32) / scale
    port_rel = np.abs(t16 - t32) / scale
    print(f"bf16 drift / max(|f32|, 2): JAX {np.round(jax_rel, 4)}, port "
          f"{np.round(port_rel, 4)}")
    assert jax_rel.max() <= 0.05 and port_rel.max() <= 0.05
    assert port_rel.max() <= 2 * jax_rel.max()
