"""The PyTorch port's AASIST forward, weights and Scorer against the JAX
package and the reference goldens, on the CPU."""

import os

import numpy as np
import pytest
import torch

import jax

from aasist_tpu.models.aasist import count_params as jax_count_params
from aasist_tpu.ops.long_audio import make_windows as jax_make_windows
from aasist_tpu.registry import build_model as jax_build_model

from aasist_tpu_torch.config import load_config
from aasist_tpu_torch.data.dataset import pad_to_fixed
from aasist_tpu_torch.models.aasist import count_params
from aasist_tpu_torch.ops.long_audio import make_windows
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.serving import Scorer
from aasist_tpu_torch.weights import load_jax_params, load_npz

ROOT = os.path.join(os.path.dirname(__file__), "..")

SMALL_CONF = {
    "architecture": "AASIST",
    "first_conv": 128,
    "filts": [70, [1, 8], [8, 8], [8, 12], [12, 12]],
    "gat_dims": [12, 16],
    "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _forward(model, x):
    with torch.inference_mode():
        hidden, logits = model(torch.from_numpy(x))
    return hidden.float().numpy(), logits.float().numpy()


@pytest.fixture(scope="module")
def small():
    """(JAX model, params, state, port model) at small widths."""
    jm = jax_build_model(SMALL_CONF)
    params, state = jm.init(jax.random.PRNGKey(0))
    params, state = _np_tree(params), _np_tree(state)
    rng = np.random.default_rng(11)
    # move the BatchNorm statistics off their init values
    state["first_bn"] = {"mean": np.asarray([0.05], np.float32),
                         "var": np.asarray([0.8], np.float32)}
    for bs in state["encoder"]:
        for bn in bs.values():
            bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(
                np.float32)
    tm = load_jax_params(build_model(SMALL_CONF), params, state)
    return jm, params, state, tm


@pytest.mark.parametrize("fused", [False, True, "stack"])
def test_small_model_matches_jax(small, fused):
    """Unfused, with the fused frontend (True), and with the frontend +
    block-0 pair ("stack"), which the JAX model's unfused apply pins."""
    jm, params, state, tm = small
    x = (np.random.default_rng(12).standard_normal((2, 16000))
         * 0.05).astype(np.float32)
    (rh, rl), _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False))(
        params, state, x)
    tm.use_fused_frontend = fused is True
    tm.use_fused_stack = fused == "stack"
    try:
        hidden, logits = _forward(tm, x)
    finally:
        tm.use_fused_frontend = tm.use_fused_stack = False
    np.testing.assert_allclose(logits, np.asarray(rl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(hidden, np.asarray(rh), atol=1e-4, rtol=0)


def _pretrained(conf_name, npz_name):
    cfg = load_config(os.path.join(ROOT, "configs", conf_name))
    return load_npz(build_model(cfg.model_config),
                    os.path.join(ROOT, "checkpoints", npz_name))


@pytest.mark.parametrize("conf,npz,golden", [
    ("AASIST.conf", "AASIST.npz", "aasist_golden.npz"),
    ("AASIST-L.conf", "AASIST-L.npz", "aasist_l_golden.npz"),
])
def test_pretrained_matches_reference_golden(conf, npz, golden,
                                             golden_dir):
    """Same gate as tests/test_aasist_parity.py: 2e-2 and the same
    bonafide-score order."""
    data = np.load(os.path.join(golden_dir, golden))
    hidden, logits = _forward(_pretrained(conf, npz), data["x"])
    np.testing.assert_allclose(logits, data["logits"], atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(hidden, data["hidden"], atol=2e-2, rtol=2e-2)
    assert (np.argsort(logits[:, 1])
            == np.argsort(data["logits"][:, 1])).all()


def test_pretrained_float64_structural_parity(golden_dir):
    """In float64 the port and the torch reference agree to 1e-8 (the
    golden's own band-pass bank isolates the forward's math)."""
    data = np.load(os.path.join(golden_dir, "aasist_f64_golden.npz"))
    model = _pretrained("AASIST.conf", "AASIST.npz").double()
    model.filterbank.copy_(torch.from_numpy(data["band_pass"]))
    with torch.inference_mode():
        hidden, logits = model(torch.from_numpy(data["x"]))
    assert logits.dtype == torch.float64
    np.testing.assert_allclose(logits.numpy(), data["logits"], atol=1e-8,
                               rtol=0)
    np.testing.assert_allclose(hidden.numpy(), data["hidden"], atol=1e-8,
                               rtol=0)


@pytest.mark.parametrize("conf,expected", [
    ("AASIST.conf", 297866), ("AASIST-L.conf", 85306)])
def test_param_count(conf, expected):
    model_config = load_config(
        os.path.join(ROOT, "configs", conf)).model_config
    assert count_params(build_model(model_config)) == expected
    params, _ = jax_build_model(model_config).init(jax.random.PRNGKey(0))
    assert jax_count_params(params) == expected


def test_weights_load_strictly(small):
    _, params, state, _ = small
    model = build_model(SMALL_CONF)
    extra = dict(params, stray={"weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(model, extra, state)
    missing = {k: v for k, v in params.items() if k != "pos_S"}
    with pytest.raises(KeyError, match="pos_S"):
        load_jax_params(model, missing, state)
    wrong = dict(params, master1=np.zeros((1, 1, 3), np.float32))
    with pytest.raises(ValueError, match="master1"):
        load_jax_params(model, wrong, state)


@pytest.mark.parametrize("conf", [
    {"architecture": "RawNet2Spoof"},
    {**SMALL_CONF, "res2net_width": 14},       # AASIST2's encoder
])
def test_unported_models_raise(conf):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(conf)


def _scorer(small, **kw):
    return Scorer(small[3], device="cpu", bf16=False, window=16000,
                  batch_size=4, **kw)


def test_scorer_ragged_requests_match_forward(small):
    rng = np.random.default_rng(13)
    waves = [(rng.standard_normal(n) * 0.05).astype(np.float32)
             for n in (9000, 16000, 23000, 4000, 12000, 16001)]
    scorer = _scorer(small)
    assert scorer.model is not small[3]               # caller's model kept
    scores = scorer.score_waveforms(waves)
    rows = np.stack([pad_to_fixed(w, 16000) for w in waves])
    _, logits = _forward(small[3], rows)
    assert len(scores) == len(waves)
    np.testing.assert_allclose(scores, logits[:, 1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(scorer.score_batch(rows[:3]), logits[:3, 1],
                               atol=1e-5, rtol=0)


def test_scorer_long_audio_windows(small):
    rng = np.random.default_rng(14)
    waves = [(rng.standard_normal(n) * 0.05).astype(np.float32)
             for n in (7000, 16000, 41000)]
    for w in waves:
        for hop in (8000, 32300):
            np.testing.assert_array_equal(make_windows(w, 16000, hop),
                                          jax_make_windows(w, 16000, hop))
    scorer = _scorer(small)
    got = scorer.score_waveforms(waves, long_audio=True)
    want = []
    for w in waves:
        # the scorer keeps the default hop (half the 64,600 window), as
        # the JAX Scorer does
        _, logits = _forward(small[3], make_windows(w, 16000))
        want.append(logits[:, 1].mean())
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
