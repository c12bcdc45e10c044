"""The zoo through the PyTorch port's entry points, on the CPU: the
registry, ``Scorer`` and ``python -m aasist_tpu_torch.cli --eval``.

Each architecture's CPU ``Scorer`` equals its forward (the score is element
[1]'s bonafide column: AASIST-Robust's main head, not its ensemble);
``cli.main --eval --device cpu`` over a small synthetic corpus equals a
``Scorer`` on the same rows, with weights as ``.npz`` or ``.pth``; the
registry and the serving batches are the JAX package's; asking a model for
a kernel path it lacks raises; the one row of RawGAT-ST's 512-utterance
golden whose score turns on a near-tie of node order.  Under ``-m slow``:
the 512-utterance e2e goldens of AASIST2, RawGAT-ST and RawNet2 through
``cli.main``.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from aasist_tpu.registry import build_model as jax_build_model
from aasist_tpu.registry import list_architectures as jax_architectures
from aasist_tpu.serving import (
    SERVING_BATCH_DEFAULTS as JAX_SERVING_BATCH_DEFAULTS)
from aasist_tpu.utils.torch_compat import (
    fill_from_state_dict as jax_fill_from_state_dict)

from aasist_tpu_torch import cli
from aasist_tpu_torch.config import PACKAGED_CONFIGS, load_config
from aasist_tpu_torch.data import synthetic
from aasist_tpu_torch.data.dataset import AudioStore, pad_to_fixed
from aasist_tpu_torch.evaluation.metrics import calculate_tdcf_eer
from aasist_tpu_torch.evaluation.scorefile import (read_score_file,
                                                   write_score_file)
from aasist_tpu_torch.registry import build_model, list_architectures
from aasist_tpu_torch.serving import SERVING_BATCH_DEFAULTS, Scorer
from aasist_tpu_torch.utils.torch_compat import fill_from_state_dict
from aasist_tpu_torch.weights import save_npz

from test_torch_zoo_models import NARROW

ROOT = Path(__file__).resolve().parent.parent
GOLDENS = ROOT / "tests" / "goldens"
# architectures the port has and the JAX package does not
PORT_ONLY = ["SSL_AASIST"]
# the stock config each architecture's runs start from
STOCK = {"AASIST2": "AASIST2", "AASIST_Robust": "AASIST-Robust",
         "RawNetGatSpoofST": "RawGATST_baseline",
         "RawNet2Spoof": "RawNet2_baseline"}


def _seeded(arch):
    """The narrow model of ``arch`` with seeded torch weights and its
    BatchNorm statistics off 0 / 1."""
    torch.manual_seed(5)
    model = build_model(NARROW[arch])
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                bn.running_mean.normal_(0, 0.2)
                bn.running_var.uniform_(0.5, 1.5)
    return model


def test_registry_is_the_jax_packages():
    """The JAX package's architectures and serving batches, and the port's
    own (``PORT_ONLY``) beside them."""
    assert list_architectures() == sorted(jax_architectures() + PORT_ONLY)
    assert SERVING_BATCH_DEFAULTS == {**JAX_SERVING_BATCH_DEFAULTS,
                                      "SSL_AASIST": 128}
    for path in sorted(PACKAGED_CONFIGS.glob("*.conf")):
        cfg = load_config(path)
        model = build_model(cfg.model_config)
        assert not model.training, path
    alias = build_model({**NARROW["AASIST2"], "res2net_width": 14})
    assert alias.encoder_type == "res2net"
    with pytest.raises(KeyError, match="RawNet3"):
        build_model({"architecture": "RawNet3"})


@pytest.mark.parametrize("arch", sorted(NARROW))
def test_cpu_scorer_equals_forward(arch):
    model = _seeded(arch)
    rng = np.random.default_rng(6)
    waves = [(rng.standard_normal(n) * 0.05).astype(np.float32)
             for n in (30000, 64600, 70000)]
    scorer = Scorer(model, device="cpu", bf16=False, batch_size=2)
    assert scorer.batch_size == 2 and not scorer.model.training
    got = scorer.score_waveforms(waves)
    rows = torch.from_numpy(np.stack([pad_to_fixed(w) for w in waves]))
    with torch.inference_mode():
        first, second = model(rows)
    np.testing.assert_allclose(got, second[:, 1].numpy(), atol=1e-5, rtol=0)
    if arch == "AASIST_Robust":
        assert not np.allclose(got, first[:, 1].numpy(), atol=1e-3)


@pytest.mark.parametrize("arch", sorted(NARROW))
def test_kernel_paths_a_model_lacks_raise(arch):
    """The frontend + block-0 pair is AASIST's residual encoder's; RawNet2
    has no frontend kernel.  Asked for, either raises, in the Scorer, on
    the attribute and in the config."""
    model = _seeded(arch)
    with pytest.raises(ValueError, match="fused frontend \\+ block-0|"
                       "residual block 0"):
        Scorer(model, device="cpu", use_fused_stack=True)
    with pytest.raises(ValueError, match="use_fused_stack"):
        build_model({**NARROW[arch], "use_fused_stack": True})
    if arch == "AASIST2":
        with pytest.raises(ValueError, match="res2net encoder"):
            model.use_fused_stack = True
    if arch == "RawNet2Spoof":
        with pytest.raises(ValueError, match="no fused frontend path"):
            Scorer(model, device="cpu", use_fused_frontend=True)
        with pytest.raises(ValueError, match="use_fused_frontend"):
            build_model({**NARROW[arch], "use_fused_frontend": True})
    else:
        assert Scorer(model, device="cpu", use_fused_frontend=True
                      ).model.use_fused_frontend


def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def _config(tmp, arch, model_config, database, weights, **keys):
    conf = json.loads((ROOT / "configs" / f"{STOCK[arch]}.conf").read_text())
    conf.update(database_path=str(database), model_path=str(weights), **keys)
    conf["model_config"] = model_config
    path = tmp / f"{STOCK[arch]}.conf"
    path.write_text(json.dumps(conf))
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """An 8-utterance eval split (WAV): (root, its rows in the protocol's
    order, padded to the window)."""
    root = tmp_path_factory.mktemp("zoo") / "LA"
    ids = synthetic.generate(root, n_train=1, n_dev=1, n_eval=8, seed=8,
                             audio_format="wav")["eval"]
    store = AudioStore(root / "ASVspoof2019_LA_eval")
    return root, ids, [store.read(u) for u in ids]


@pytest.mark.parametrize("arch,fmt", [
    ("AASIST2", ".pth"), ("AASIST_Robust", ".npz"),
    ("RawNetGatSpoofST", ".npz"), ("RawNet2Spoof", ".pth")])
def test_cli_eval_equals_a_scorer(arch, fmt, corpus, tmp_path):
    """``--eval`` at eval batch 3 (three batches, the last of 2 rows)
    against a Scorer of batch 3 on the same rows; the weights reach the
    CLI as written by ``save_npz`` or ``torch.save`` of the state dict."""
    root, ids, waves = corpus
    model = _seeded(arch)
    weights = tmp_path / f"w{fmt}"
    if fmt == ".npz":
        save_npz(model, weights)
    else:
        torch.save(model.state_dict(), weights)
    conf = _config(tmp_path, arch, NARROW[arch], root, weights,
                   eval_batch_size=3)
    rc, out = _run_cli(["--config", str(conf), "--eval", "--device", "cpu",
                        "--output_dir", str(tmp_path / "exp")])
    assert rc == 0
    cfg = load_config(conf)
    run_dir = tmp_path / "exp" / cfg.model_tag(conf.stem)
    rows = read_score_file(run_dir / cfg.eval_output)
    assert [r[0] for r in rows] == ids
    want = Scorer(model, device="cpu", bf16=False,
                  batch_size=3).score_waveforms(waves)
    np.testing.assert_allclose([r[3] for r in rows], want, atol=1e-6,
                               rtol=0)
    eer, tdcf = calculate_tdcf_eer(run_dir / cfg.eval_output,
                                   cfg.asv_scores(), printout=False)
    assert out.strip().splitlines()[-1] == (
        f"DONE. EER: {eer:.3f}%, min t-DCF: {tdcf:.5f}")


def test_cli_eval_strict_on_an_unfilled_leaf(corpus, tmp_path):
    """A .pth without AASIST2's speaker-conditioning head stops --eval
    before anything is scored."""
    model = _seeded("AASIST2")
    weights = tmp_path / "w.pth"
    torch.save({k: v for k, v in model.state_dict().items()
                if not k.startswith("spk_cond_gat.")}, weights)
    conf = _config(tmp_path, "AASIST2", NARROW["AASIST2"], corpus[0],
                   weights)
    with pytest.raises(ValueError, match="spk_cond_gat"):
        _run_cli(["--config", str(conf), "--eval", "--device", "cpu",
                  "--output_dir", str(tmp_path / "exp")])


def _chip_smoke():
    """chip_smoke.py as a module (its top level imports the standard
    library only)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden_sd(name):
    data = np.load(GOLDENS / name)
    return {k[len("sd__"):]: data[k] for k in data.files
            if k.startswith("sd__")}


@pytest.fixture(scope="module")
def corpus99(tmp_path_factory):
    """The seed-99 corpus of e2e_diff_big_*.npz (2/2/512 utterances, WAV)."""
    base = tmp_path_factory.getbasetemp() / "zoo_la99"
    if not (base / ".complete").exists():
        synthetic.generate(base / "LA", n_train=2, n_dev=2, n_eval=512,
                           seed=99, audio_format="wav")
        (base / ".complete").write_text("ok\n")
    return base / "LA"


def test_the_rawgatst_goldens_utterance_49_is_a_node_order_tie(
        corpus99, monkeypatch):
    """e2e_diff_big_RawGATST.npz's LA_E_9900049 turns on a near-tie inside
    the model: pool_ST's 4th and 5th kept nodes score 6.1e-9 apart in
    float64, and proj_ST / out_layer weigh the kept nodes by rank.  The
    JAX package and the port read the golden's order on the CPU; the port's
    f32 forward with that pair swapped gives chip_smoke.py's
    ZOO_NODE_ORDER_TIES value, 1.8e-3 off the golden (the card's reading).
    No other kept pair and no top-k cut of the three pools is that close."""
    utt = "LA_E_9900049"
    golden = np.load(GOLDENS / "e2e_diff_big_RawGATST.npz")
    ref = float(golden["scores"][[str(u) for u in
                                  golden["utt_ids"]].index(utt)])
    x = pad_to_fixed(AudioStore(corpus99 / "ASVspoof2019_LA_eval").read(
        utt)).astype(np.float32)[None]
    sd = _golden_sd("rawgatst_golden.npz")
    model_config = load_config("RawGATST_baseline").model_config
    jm = jax_build_model(model_config)
    zeros = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    params, state = jax_fill_from_state_dict(*zeros, sd)
    j32 = float(jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False)[0][
        1])(params, state, x)[0, 1])
    model = fill_from_state_dict(build_model(model_config), sd)
    with torch.inference_mode():
        t32 = float(model(torch.from_numpy(x))[1][0, 1])
    other = _chip_smoke().ZOO_NODE_ORDER_TIES["RawGATST"][utt]
    print(f"golden {ref:.7f}, JAX f32 {j32:.7f}, port f32 {t32:.7f}, "
          f"ZOO_NODE_ORDER_TIES {other}")
    assert abs(t32 - ref) < 1e-5 and abs(j32 - ref) < 1e-5
    assert abs(other - ref) > 1e-3

    gaps = {}

    def record(name):
        def hook(mod, args, out):
            s = torch.sort(torch.sigmoid(mod.proj(args[0]))[0, :, 0],
                           descending=True).values
            n_keep = max(int(len(s) * mod.k), mod.min_nodes)
            gaps[name] = (s[:n_keep] - s[1:n_keep + 1]).numpy()
        return hook

    model64 = build_model(model_config).double()
    model64.load_state_dict(model.state_dict())
    for name in ("pool_T", "pool_S", "pool_ST"):
        getattr(model64, name).register_forward_hook(record(name))
    with torch.inference_mode():
        model64(torch.from_numpy(x).double())
    tie = gaps["pool_ST"][3]            # between kept nodes 4 and 5
    others = np.concatenate([np.delete(gaps["pool_ST"], 3), gaps["pool_T"],
                             gaps["pool_S"]])
    print(f"pool_ST gap at 4/5 {tie:.3e}; smallest other gap "
          f"{others.min():.3e}")
    assert tie < 1e-7 and others.min() > 1e-6

    pool = model.pool_ST

    def swapped(h, rngs=None):      # the pool's forward takes the stream
        s = torch.sigmoid(pool.proj(h))[..., 0]
        idx = torch.topk(s, 7, dim=1, sorted=True).indices
        h = h * s[..., None]
        idx = idx[:, [0, 1, 2, 4, 3, 5, 6]]
        return torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))

    monkeypatch.setattr(pool, "forward", swapped)
    with torch.inference_mode():
        t_swapped = float(model(torch.from_numpy(x))[1][0, 1])
    assert abs(t_swapped - other) < 1e-6


# the 512-utterance goldens: architecture -> (stock config, golden weights)
BIG = {"AASIST2": ("AASIST2", "aasist2_golden.npz"),
       "RawGATST": ("RawGATST_baseline", "rawgatst_golden.npz"),
       "RawNet2": ("RawNet2_baseline", "rawnet2_golden.npz")}


@pytest.mark.slow
@pytest.mark.parametrize("arch", sorted(BIG))
def test_cli_eval_reproduces_the_512_utterance_golden(arch, corpus99,
                                                      tmp_path):
    """The seed-99 corpus through ``cli.main --eval --device cpu`` at full
    width, with the golden's seeded reference state dict as a ``.pth``,
    against ``e2e_diff_big_{arch}.npz``: scores within 1e-4, the ranking
    equal but for pairs whose reference scores lie within 2e-4 (the tie
    rule of tools/verify_reference_parity.py), EER / min t-DCF within
    1e-10.  A row of chip_smoke.py's ZOO_NODE_ORDER_TIES is held to the
    golden or to its reading in the other node order (and the metrics to
    those of the scores it is held to), as in chip_smoke.py phase 8."""
    stock, name = BIG[arch]
    weights = tmp_path / "golden.pth"
    torch.save({k: torch.from_numpy(v)
                for k, v in _golden_sd(name).items()}, weights)
    conf = _config(tmp_path, {"AASIST2": "AASIST2", "RawGATST":
                              "RawNetGatSpoofST", "RawNet2": "RawNet2Spoof"}[
                                  arch],
                   load_config(stock).model_config, corpus99, weights,
                   eval_batch_size=32)
    rc, _ = _run_cli(["--config", str(conf), "--eval", "--device", "cpu",
                      "--output_dir", str(tmp_path / "exp")])
    assert rc == 0
    cfg = load_config(conf)
    run_dir = tmp_path / "exp" / cfg.model_tag(conf.stem)
    golden = np.load(GOLDENS / f"e2e_diff_big_{arch}.npz")
    got = read_score_file(run_dir / cfg.eval_output)
    ids = [str(u) for u in golden["utt_ids"]]
    assert [r[0] for r in got] == ids
    scores = np.asarray([r[3] for r in got])
    ref = np.asarray(golden["scores"], np.float64)
    ref_metrics = float(golden["eer"]), float(golden["min_tdcf"])
    for utt, other in _chip_smoke().ZOO_NODE_ORDER_TIES.get(arch,
                                                            {}).items():
        i = ids.index(utt)
        if abs(scores[i] - other) < abs(scores[i] - ref[i]):
            ref[i] = other
            write_score_file(tmp_path / "held.txt", ids, ref.tolist(),
                             {r[0]: (r[1], r[2]) for r in got})
            ref_metrics = calculate_tdcf_eer(
                tmp_path / "held.txt", cfg.asv_scores(), printout=False)
    d = np.abs(scores - ref)
    print(f"{arch}: max|d| {d.max():.3e} at {int(np.argmax(d))}")
    assert d.max() < 1e-4
    order, ref_order = np.argsort(scores), np.argsort(ref)
    swaps = order != ref_order
    assert np.all(np.abs(ref[order[swaps]] - ref[ref_order[swaps]]) < 2e-4)
    eer, tdcf = calculate_tdcf_eer(run_dir / cfg.eval_output,
                                   cfg.asv_scores(), printout=False)
    assert eer == pytest.approx(ref_metrics[0], abs=1e-10)
    assert tdcf == pytest.approx(ref_metrics[1], abs=1e-10)
