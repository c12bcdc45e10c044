"""The zoo's eval forwards in the PyTorch port, on the CPU: AASIST2 (the
Res2Net encoder and speaker conditioning), AASIST-Robust, RawGAT-ST and
RawNet2.

At full width, against the reference goldens: the seeded reference state
dicts (``sd__*``) carried in through ``utils/torch_compat.py``, logits at
the JAX package's own tolerances (``tests/test_aasist2.py``,
``tests/test_baseline_models.py``), and the parameter counts.  At narrow
channels, against the JAX model on the same input: seeded weights in the
JAX model's tree carried in by ``load_jax_params``, f32 at 1e-4, 64,600
samples (RawGAT-ST's projections fix its node counts), the JAX side on its
plain frontend and the port's with and without its frontend route (the CPU
takes the kernel's plain version; the kernel is held by the frontend's own
tests).
"""

import os

import numpy as np
import pytest
import torch

import jax

from aasist_tpu.models.aasist import count_params as jax_count_params
from aasist_tpu.registry import build_model as jax_build_model

from aasist_tpu_torch.config import load_config
from aasist_tpu_torch.models.aasist import count_params
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.utils.torch_compat import fill_from_state_dict
from aasist_tpu_torch.weights import load_jax_params

from test_torch_zoo_layers import perturb_bn

# stock config, golden, logits tolerance, hidden tolerance
GOLDEN_ARCHS = {
    "AASIST2": ("AASIST2", "aasist2_golden.npz", 1e-3, 1e-3),
    "RawGATST": ("RawGATST_baseline", "rawgatst_golden.npz", 5e-4, 5e-3),
    "RawNet2": ("RawNet2_baseline", "rawnet2_golden.npz", 5e-4, 5e-3),
}

NARROW = {
    "AASIST2": {
        "architecture": "AASIST2", "first_conv": 128,
        # 16 input channels: fourteen splits, the carry at split 8
        "filts": [70, [1, 16], [16, 16], [16, 16], [16, 16]],
        "gat_dims": [12, 16], "pool_ratios": [0.5, 0.7, 0.5, 0.5],
        "temperatures": [2.0, 2.0, 100.0, 100.0],
        "res2net_width": 14, "res2net_scale": 8,
        "speaker_conditioning": True, "spk_emb_dim": 24,
        "conditioning_level": "frame", "use_attention": True},
    "AASIST_Robust": {
        "architecture": "AASIST_Robust", "first_conv": 128,
        "filts": [70, [1, 8], [8, 8], [8, 12], [12, 12]],
        "gat_dims": [12, 16], "pool_ratios": [0.4, 0.5, 0.7, 0.5],
        "temperatures": [2.0, 2.0, 100.0, 50.0]},
    "RawNetGatSpoofST": {
        "architecture": "RawNetGatSpoofST", "first_conv": 128,
        "filts": [70, [1, 8], [8, 8], [8, 12], [12, 12]]},
    "RawNet2Spoof": {
        "architecture": "RawNet2Spoof", "first_conv": 1024,
        "filts": [20, [20, 20], [20, 16], [16, 16]], "gru_node": 32,
        "nb_gru_layer": 2, "nb_fc_node": 16, "nb_classes": 2},
}


def _forward(model, x, **kw):
    with torch.inference_mode():
        out = model(torch.from_numpy(x), **kw)
    return [o.float().numpy() for o in out]


@pytest.fixture(scope="module")
def golden_models(golden_dir):
    """arch -> (port model filled from the golden's sd__, golden)."""
    out = {}
    for arch, (conf, name, _, _) in GOLDEN_ARCHS.items():
        data = np.load(os.path.join(golden_dir, name))
        model = build_model(load_config(conf).model_config)
        fill_from_state_dict(model, {k[len("sd__"):]: data[k]
                                     for k in data.files
                                     if k.startswith("sd__")})
        out[arch] = model, data
    return out


@pytest.mark.parametrize("arch", sorted(GOLDEN_ARCHS))
def test_golden_logits(golden_models, arch):
    model, data = golden_models[arch]
    _, _, tol_logits, tol_hidden = GOLDEN_ARCHS[arch]
    hidden, logits = _forward(model, data["x"])
    np.testing.assert_allclose(logits, data["logits"], atol=tol_logits,
                               rtol=tol_logits)
    np.testing.assert_allclose(hidden, data["hidden"], atol=tol_hidden,
                               rtol=tol_hidden)


def test_aasist2_speaker_conditioned_logits(golden_models):
    model, data = golden_models["AASIST2"]
    assert model.encoder_type == "res2net"
    hidden, logits = _forward(model, data["x"],
                              speaker_embedding=torch.from_numpy(
                                  data["spk"]))
    np.testing.assert_allclose(logits, data["logits_spk"], atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(hidden, data["hidden_spk"], atol=1e-3,
                               rtol=1e-3)
    assert not np.allclose(data["logits"], data["logits_spk"])


@pytest.mark.parametrize("conf,expected", [
    ("AASIST2", 259079), ("AASIST-Robust", None),
    ("RawGATST_baseline", 437034), ("RawNet2_baseline", 17621410)])
def test_param_count(conf, expected):
    """The goldens' n_params; AASIST-Robust, which has none, the JAX
    package's count (the unused denoising block and master2 included)."""
    model_config = load_config(conf).model_config
    params, _ = jax.eval_shape(jax_build_model(model_config).init,
                               jax.random.PRNGKey(0))
    assert count_params(build_model(model_config)) == jax_count_params(
        params) == (expected or jax_count_params(params))


def seeded_tree(jm, rng):
    """(params, state) in the JAX model's own tree (``jax.eval_shape`` of
    its ``init``), every leaf drawn by numpy from ``rng``: U(-1, 1) over
    the square root of the fan-in, BatchNorm moved off 0 / 1.  (The JAX
    package's eager init of the narrow AASIST2 takes ~20 s on the CPU.)"""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda a: (rng.uniform(-1, 1, a.shape)
                   / np.sqrt(max(1, np.prod(a.shape[1:])))).astype(
                       np.float32), shapes)
    return perturb_bn(*tree, rng)


@pytest.fixture(scope="module")
def narrow():
    """arch -> (JAX model, params, state, port model with its weights)."""
    out = {}
    for arch, conf in NARROW.items():
        jm = jax_build_model(conf)
        params, state = seeded_tree(jm, np.random.default_rng(21))
        out[arch] = jm, params, state, load_jax_params(build_model(conf),
                                                       params, state)
    return out


@pytest.mark.parametrize("arch,fused", [
    ("AASIST2", False), ("AASIST2", True),
    ("AASIST_Robust", False), ("AASIST_Robust", True),
    ("RawNetGatSpoofST", False), ("RawNetGatSpoofST", True),
    ("RawNet2Spoof", False)])
def test_narrow_model_matches_jax(narrow, arch, fused):
    """Both outputs of each forward (Robust: the ensemble and the main
    head; AASIST2 with a speaker embedding as well) at 1e-4."""
    jm, params, state, model = narrow[arch]
    rng = np.random.default_rng(22)
    x = (rng.standard_normal((2, 64600)) * 0.05).astype(np.float32)
    kws = [{}]
    if arch == "AASIST2":
        kws.append({"speaker_embedding": rng.standard_normal(
            (2, 24)).astype(np.float32)})
    if fused:
        model.use_fused_frontend = True
    try:
        for kw in kws:
            (ra, rb), _ = jax.jit(lambda p, s, x, kw: jm.apply(
                p, s, x, train=False, **kw))(params, state, x, kw)
            got = _forward(model, x, **{k: torch.from_numpy(v)
                                        for k, v in kw.items()})
            np.testing.assert_allclose(got[0], np.asarray(ra), atol=1e-4,
                                       rtol=0)
            np.testing.assert_allclose(got[1], np.asarray(rb), atol=1e-4,
                                       rtol=0)
    finally:
        if fused:
            model.use_fused_frontend = False
    if arch == "AASIST_Robust":
        assert not np.allclose(got[0], got[1])      # the aux head mixes in
    if arch == "RawNet2Spoof":
        np.testing.assert_allclose(np.exp(got[1]).sum(axis=1), 1.0,
                                   atol=1e-6)


def test_robust_denoising_block_matches_jax(narrow):
    """The non-local denoising block in train mode (the only mode the
    model runs it in) against the JAX package's ``_denoise_apply``: its
    output and its BatchNorm's running statistics, f32 at 1e-5; the eval
    forward never calls it."""
    import copy

    from aasist_tpu.models.aasist_robust import _denoise_apply

    _, params, state, model = narrow["AASIST_Robust"]
    block = copy.deepcopy(model.denoising).train()
    x = np.random.default_rng(24).standard_normal((3, 12, 5)).astype(
        np.float32)
    want, want_s = _denoise_apply(params["denoising"], state["denoising"],
                                  x, train=True)
    got = block(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(block.bn, f"running_{k}").numpy(),
            np.asarray(want_s["bn"][k]), atol=1e-5, rtol=1e-5)


def test_utterance_level_conditioning_fails_as_the_jax_packages():
    """At the utterance level the readout (5 x gat_dims[1]) and the
    projected embedding do not fit the fusion layer's 2 x gat_dims[1]
    inputs: the JAX model raises, and so does the port (a fault of the
    reference kept; the module alone works at that level,
    tests/test_torch_zoo_layers.py)."""
    conf = {**NARROW["AASIST2"], "conditioning_level": "utterance"}
    jm = jax_build_model(conf)
    params, state = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    x = np.zeros((1, 16000), np.float32)
    spk = np.zeros((1, 24), np.float32)
    with pytest.raises(ValueError, match="does not match"):
        jax.eval_shape(lambda p, s: jm.apply(p, s, x, train=False,
                                             speaker_embedding=spk),
                       params, state)
    with pytest.raises(RuntimeError, match="cannot be multiplied"):
        _forward(build_model(conf), x,
                 speaker_embedding=torch.from_numpy(spk))
    _forward(build_model(conf), x)       # without an embedding it runs
