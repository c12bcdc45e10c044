"""The port's parity tool (``aasist_tpu_torch/tools/verify_reference_parity``)
on the CPU.

Its scoring against the JAX tool's ``_score_corpus`` on the same 8-utterance
synthetic corpus with a narrow AASIST carrying the same weights; the
verdict's logic on canned scores (the thresholds, the golden gates, the
node-order tie rows held by id, the exit codes); the real-corpus mode run on
a synthetic corpus laid out as LA (a verdict line, "pass": false, exit 1);
TF32 off while it scores, and restored.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from aasist_tpu.registry import build_model as jax_build_model

from aasist_tpu_torch.data import synthetic
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.tools import _common
from aasist_tpu_torch.tools import verify_reference_parity as vrp
from aasist_tpu_torch.utils.pytree_io import flatten_tree, unflatten_tree
from aasist_tpu_torch.weights import jax_trees, load_jax_params

ROOT = Path(__file__).resolve().parent.parent

NARROW = {
    "architecture": "AASIST",
    "first_conv": 128,
    "filts": [70, [1, 8], [8, 8], [8, 12], [12, 12]],
    "gat_dims": [12, 16],
    "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module (restored after): the suite runs six
    workers on eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    """tools/verify_reference_parity.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_verify_reference_parity",
        ROOT / "tools" / "verify_reference_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """An 8-utterance eval split laid out as LA (WAV, seed 31)."""
    root = tmp_path_factory.mktemp("parity") / "LA"
    synthetic.generate(root, n_train=2, n_dev=2, n_eval=8, seed=31,
                       audio_format="wav")
    return root


def narrow_weights(seed: int):
    """Seeded (params, state) trees of NARROW in the JAX package's layout:
    the port's init from ``seed`` (``weights.jax_trees``), BatchNorm
    statistics off their init."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        params, state = (unflatten_tree(flatten_tree(t))   # JAX's lists
                         for t in jax_trees(build_model(NARROW)))
    rng = np.random.default_rng(seed)
    for bs in state["encoder"]:
        for bn in bs.values():
            bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(
                np.float32)
    return params, state


@pytest.fixture(scope="module")
def narrow():
    """(JAX model, params, state, the port's model with the same weights
    through ``load_jax_params``)."""
    params, state = narrow_weights(4)
    return (jax_build_model(NARROW), params, state,
            load_jax_params(build_model(NARROW), params, state))


def test_scoring_matches_the_jax_tools(corpus, narrow, tmp_path):
    """The same corpus and weights through both tools' scoring: scores
    within 1e-5, EER and min t-DCF within 1e-10."""
    jm, params, state, model = narrow
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    j_ids, j_scores, j_eer, j_tdcf = _jax_tool()._score_corpus(
        str(corpus), 4, str(tmp_path / "jax"), model=jm, params=params,
        state=state)
    ids, scores, eer, tdcf = vrp.score_corpus(corpus, 4, tmp_path / "port",
                                              model=model, device="cpu")
    print(f"max|d| {np.abs(scores - j_scores).max():.3e}; EER {eer!r} / "
          f"{j_eer!r}; min t-DCF {tdcf!r} / {j_tdcf!r}")
    assert list(ids) == list(j_ids) and len(ids) == 8
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-5)
    assert abs(eer - j_eer) < 1e-10 and abs(tdcf - j_tdcf) < 1e-10
    assert (tmp_path / "port" / "parity_scores.txt").is_file()


def test_scoring_runs_with_tf32_off_and_restores_it(corpus, narrow,
                                                    tmp_path, monkeypatch):
    """An f32 run misses the gates with TF32 on: the tool turns cuDNN's and
    cuBLAS's TF32 off while it scores, and restores both after."""
    from aasist_tpu_torch.train import loop

    seen = []

    def spy(model, batcher):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        ids = batcher.utt_ids
        return ids, np.linspace(-1, 1, len(ids)).tolist()

    monkeypatch.setattr(loop, "produce_scores", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    vrp.score_corpus(corpus, 8, tmp_path, model=narrow[3], device="cpu")
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("eer, tdcf, ok", [
    (0.84, 0.0276, True), (0.83, 0.0275, True), (0.8401, 0.0275, False),
    (0.83, 0.02761, False), (5.0, 0.5, False)])
def test_real_verdict_thresholds(eer, tdcf, ok):
    v = vrp.real_verdict(eer, tdcf)
    assert v["pass"] is ok
    assert (v["eer_threshold"], v["tdcf_threshold"]) == (0.84, 0.0276)


def _golden(n=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = [f"LA_E_99{i:05d}" for i in range(n)]
    scores = np.sort(rng.uniform(-8, 4, n))[rng.permutation(n)]
    return {"utt_ids": np.asarray(ids), "scores": scores, "eer": 12.5,
            "min_tdcf": 0.25}


def _verdict(scores, golden, eer=12.5, tdcf=0.25, **kw):
    kw.setdefault("tol", 1e-4)
    kw.setdefault("swap_tie", 0.0)
    return vrp.golden_verdict([str(u) for u in golden["utt_ids"]], scores,
                              eer, tdcf, golden, **kw)


def test_golden_verdict_gates():
    """Scores within the tolerance, the same ranking and the metrics within
    1e-10 pass; each gate alone fails."""
    g = _golden()
    ref = g["scores"]
    assert _verdict(ref + 5e-5, g)["pass"]
    assert not _verdict(ref + np.where(np.arange(12) == 3, 2e-4, 0), g)[
        "pass"]
    assert not _verdict(ref, g, eer=12.5 + 1e-9)["pass"]
    assert not _verdict(ref, g, tdcf=0.25 - 1e-9)["pass"]
    # two utterances 5e-5 apart in the golden, read in the other order
    g2 = dict(g, scores=ref.copy())
    i, j = int(np.argmax(ref)), int(np.argmin(ref))
    g2["scores"][j] = ref[i] - 5e-5
    got = g2["scores"].copy()
    got[i], got[j] = got[j], got[i]
    assert not _verdict(got, g2)["pass"]                 # synthetic: exact
    assert _verdict(got, g2, swap_tie=2e-4)["pass"]      # big: 2 tol ties
    with pytest.raises(ValueError, match="not the golden's"):
        vrp.golden_verdict(["x"] * 12, ref, 12.5, 0.25, g, 1e-4, 0.0)


def test_a_node_order_tie_row_is_held_by_id():
    """The tie table's row may read the other order's score, and then the
    reference metrics are those of the held scores; any other row that far
    off fails, and the row held to the golden keeps the golden's metrics."""
    (utt, other), = vrp.BIG_TIES["AASIST"].items()
    g = _golden()
    g["utt_ids"][5] = utt
    g["scores"][5] = other + 7.1e-3
    got = g["scores"].copy()
    got[5] = other + 3e-5
    calls = []

    def rescore(ref):
        calls.append(ref.copy())
        return 12.0, 0.2

    v = _verdict(got, g, eer=12.0, tdcf=0.2, ties={utt: other},
                 rescore=rescore)
    assert v["pass"] and len(calls) == 1 and calls[0][5] == other
    assert v["node_order_ties"][utt]["held_to"] == "other_order"
    assert (v["reference_eer_pct"], v["reference_min_tdcf"]) == (12.0, 0.2)
    # the same offset on a row not in the table
    assert not _verdict(got, g, eer=12.0, tdcf=0.2)["pass"]
    # read as the golden: held to it, the golden's metrics, no rescoring
    v = _verdict(g["scores"], g, ties={utt: other}, rescore=rescore)
    assert v["pass"] and len(calls) == 1
    assert v["node_order_ties"][utt]["held_to"] == "golden"


def test_the_tie_tables_are_chip_smokes():
    """chip_smoke.py's gates read the package's one copy of the tables."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.NODE_ORDER_TIES is _common.NODE_ORDER_TIES
    assert mod.ZOO_NODE_ORDER_TIES is _common.ZOO_NODE_ORDER_TIES
    assert vrp.BIG_TIES == {"AASIST": {"LA_E_9900077": -6.7956948},
                            "RawGATST": {"LA_E_9900049": 0.19407523}}


@pytest.mark.parametrize("passes", [True, False])
def test_exit_code_follows_the_verdict(passes, monkeypatch, tmp_path):
    monkeypatch.setattr(vrp, "run_synthetic",
                        lambda *a: {"mode": "synthetic", "pass": passes})
    monkeypatch.setattr(vrp, "run_synthetic_big", lambda arch, *a: {
        "mode": "synthetic_big", "arch": arch, "pass": passes
        or arch != "RawNet2"})
    for argv in ([], ["--big"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = vrp.main(argv + ["--device", "cpu", "--out_dir",
                                  str(tmp_path)])
        verdict = json.loads(out.getvalue().strip().splitlines()[-1])
        assert rc == (0 if passes else 1) and verdict["pass"] is passes
        assert verdict["device"] == "cpu"
    assert sorted(verdict["archs"]) == sorted(vrp.BIG_ARCHS)


def test_real_mode_on_a_synthetic_corpus_fails_its_verdict(
        corpus, tmp_path, monkeypatch):
    """Real mode over the 8 synthetic utterances, the flagship stood in
    for by a narrow AASIST: one JSON verdict line, far from the published
    numbers, exit 1."""
    built = []

    def narrow_flagship(arch):
        built.append(arch)
        return load_jax_params(build_model(NARROW), *narrow_weights(7))

    monkeypatch.setattr(vrp, "build_arch", narrow_flagship)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = vrp.main(["--database_path", str(corpus), "--device", "cpu",
                       "--batch_size", "8", "--out_dir", str(tmp_path)])
    lines = out.getvalue().strip().splitlines()
    verdict = json.loads(lines[-1])
    print(lines[-1])
    assert built == ["AASIST"]
    assert rc == 1 and len(lines) == 1 and verdict["mode"] == "real"
    assert verdict["pass"] is False
    assert verdict["eer_pct"] > vrp.EER_THRESHOLD
    assert len((tmp_path / "parity_scores.txt").read_text().splitlines()) \
        == 8


def test_big_archs_are_the_jax_tools():
    """Every architecture of the JAX tool's --big, at its tolerance and
    weights; each builds from its stock config, whose model config is the
    JAX tool's (the flagship's FLAGSHIP_CONF among them), in f32 on the
    stock route, and takes its weights strictly."""
    jt = _jax_tool()
    assert sorted(vrp.BIG_ARCHS) == sorted(jt.BIG_ARCHS)
    assert jt.BIG_ARCHS["AASIST"][0] is jt.FLAGSHIP_CONF
    for arch, (conf, src, tol) in jt.BIG_ARCHS.items():
        assert vrp.BIG_ARCHS[arch][1:] == (src, tol), arch
        model = vrp.build_arch(arch)
        assert {**model.config, "nb_samp": 64600} == {**conf,
                                                      "nb_samp": 64600}
        assert next(model.parameters()).dtype == torch.float32, arch
        assert not getattr(model, "use_fused_frontend", False), arch
        assert not getattr(model, "use_fused_stack", False), arch
