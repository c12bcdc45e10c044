"""The port's train step against the JAX package's for AASIST-Robust and
RawNet2, float64, on the CPU, as ``tests/test_torch_train_models.py``
holds AASIST (its docstring says how; RawGAT-ST:
``tests/test_torch_train_rawgat.py``): RawNet2 with two accumulated
microbatches, and in float32 against the JAX package's own accumulated
step.  AASIST-Robust's input noise, whose draw is the port's own, is held
to its definition."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aasist_tpu.config import OptimConfig as JaxOptimConfig
from aasist_tpu.registry import build_model as jax_build_model
from aasist_tpu.train import loop as jax_loop
from aasist_tpu.train.losses import weighted_cce as jax_weighted_cce
from aasist_tpu.train.optim import create_optimizer as jax_create_optimizer

from aasist_tpu_torch import nn
from aasist_tpu_torch.config import OptimConfig
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.train.loop import make_train_step
from aasist_tpu_torch.train.losses import weighted_cce
from aasist_tpu_torch.train.optim import create_optimizer, make_schedule
from aasist_tpu_torch.weights import load_jax_params

from test_torch_train_models import (  # noqa: F401 (a fixture)
    NARROW, OPTIM, _batches, _case, _flat, _port, _run, one_torch_thread)
from test_torch_zoo_models import seeded_tree


def no_grad_leaves(arch):
    """The leaves the train forward of ``arch`` gives no gradient: every
    residual block's bn1 but the first's, and what AASIST-Robust's train
    forward does not reach: the auxiliary head, the ensemble weight, both
    master nodes and the master path of both HtrgGAT layers (its one
    branch drops the second layer's master)."""
    out = set()
    if arch == "AASIST_Robust":
        out = {"aux_out_layer.weight", "aux_out_layer.bias",
               "ensemble_weight", "master1", "master2"} | {
            f"HtrgGAT_layer_ST{i}.{leaf}" for i in (1, 2) for leaf in (
                "att_weightM", "att_projM.weight", "att_projM.bias",
                "proj_with_attM.weight", "proj_with_attM.bias",
                "proj_without_attM.weight", "proj_without_attM.bias")}
    blocks = {"AASIST_Robust": ["encoder."],
              "RawNetGatSpoofST": ["encoder_T.", "encoder_S."],
              "RawNet2Spoof": ["block"]}[arch]
    sep = {"RawNet2Spoof": ""}.get(arch, "")
    return out | {f"{b}{sep}{i}.bn1.{w}" for b in blocks
                  for i in range(1, 6) for w in ("weight", "bias")}


def test_robust_train_steps_match_jax():
    """Two Adam steps; the leaves without a gradient are
    ``no_grad_leaves``'s."""
    assert _run("AASIST_Robust", "adam") == no_grad_leaves("AASIST_Robust")


def test_rawnet2_accumulated_steps_match_jax():
    """Two Adam steps, each of two microbatches of two: the mean of their
    gradients, BatchNorm's statistics moved by each in turn."""
    assert (_run("RawNet2Spoof", "adam", accum=2)
            == no_grad_leaves("RawNet2Spoof"))


def test_rawnet2_f32_accumulated_step_matches_the_jax_step():
    """The JAX package's own accumulated step (RawNet2 has no dropout, so
    the two random streams do not enter), float32, one SGD step with
    momentum (linear in the gradient: an f32 Adam step would turn a
    gradient near its eps into any update up to lr): parameters to 1e-7
    (a step of lr 1e-3 on gradients within 1e-5 relative) and the
    BatchNorm statistics to 1e-5."""
    conf, length, _ = NARROW["RawNet2Spoof"]
    jm = jax_build_model(conf)
    params, state = seeded_tree(jm, np.random.default_rng(23))
    model = load_jax_params(build_model(conf), params, state).train()
    sgd = {**OPTIM, "optimizer": "sgd", "momentum": 0.9}
    cfg = OptimConfig.from_dict(sgd)
    step = make_train_step(
        model, lambda lg, y, d: weighted_cce(lg, y),
        create_optimizer(cfg, model.parameters()), make_schedule(cfg),
        seed=0, freq_aug=False, use_duration=False, grad_accum_steps=2)
    x, y, d = _batches(length, 1)[0]
    x, d = x.astype(np.float32), d.astype(np.float32)
    step(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(d), 0)
    opt = jax_create_optimizer(JaxOptimConfig.from_dict(sgd),
                               grad_mask=jm.grad_mask)
    jstep = jax_loop.make_train_step(
        jm, lambda lg, yy, dd: jax_weighted_cce(lg, yy), opt,
        freq_aug=False, use_duration=False, grad_accum_steps=2)
    p, s, _, _, _ = jstep(jax.tree_util.tree_map(jnp.asarray, params),
                          jax.tree_util.tree_map(jnp.asarray, state),
                          opt.init(params), jnp.asarray(x),
                          jnp.asarray(y.astype(np.int32)), jnp.asarray(d),
                          jax.random.PRNGKey(0))
    bufs = dict(model.named_buffers())
    want_p = _flat(p)
    for name, t in model.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), want_p[name],
                                   atol=1e-7, rtol=0, err_msg=name)
    for name, want in _flat(s, rename_state=True).items():
        np.testing.assert_allclose(bufs[name].numpy(), want, atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_grad_accumulation_needs_a_divisible_batch():
    conf, length, _ = NARROW["RawNet2Spoof"]
    model = build_model(conf).train()
    cfg = OptimConfig.from_dict({**OPTIM, "optimizer": "adam"})
    step = make_train_step(
        model, lambda lg, y, d: weighted_cce(lg, y),
        create_optimizer(cfg, model.parameters()), make_schedule(cfg),
        seed=0, freq_aug=False, use_duration=False, grad_accum_steps=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(torch.zeros(4, length), torch.zeros(4, dtype=torch.int64),
             torch.ones(4), 0)


def test_robust_input_noise():
    """In train mode AASIST-Robust adds noise_sigma * std(x) (population
    std, not differentiated) times a standard normal from its stream's
    first generator: the same forward as the noiseless model's on that
    noisy input, bit for bit."""
    _, params, state, _ = _case("AASIST_Robust")
    x = torch.from_numpy(_batches(NARROW["AASIST_Robust"][1], 1)[0][0])
    quiet = _port("AASIST_Robust", params, state)
    noisy = _port("AASIST_Robust", params, state)
    noisy.noise_sigma = 0.1
    key = (5, 7, 0)
    got = noisy(x, rngs=nn.RngStream(key, dropout_enabled=False))[1]
    g = nn.generator_for(key + (1,), "cpu")
    xn = x + 0.1 * x.std(correction=0) * torch.randn(
        x.shape, generator=g, dtype=x.dtype)
    want = quiet(xn, rngs=nn.RngStream(key, dropout_enabled=False))[1]
    assert torch.equal(got, want)
    assert not torch.equal(got, quiet(
        x, rngs=nn.RngStream(key, dropout_enabled=False))[1])
