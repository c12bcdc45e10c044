"""The robust-training extras (``train/loop.py:RobustOptions``: waveform
mixup, PGD adversarial training) against the JAX package's
``aasist_tpu/train/loop.py:_make_loss_and_grads``, on the CPU.

A narrow AASIST (20 sinc channels, 8,000 samples) with seeded weights
carried in by ``load_jax_params``, the same numpy batch, dropout and
``freq_aug`` off, float64 (``jax.enable_x64``).  The mixup draw is pinned
on both sides: the JAX package's ``_mixup_draw`` through ``monkeypatch``
(no file edited), the port's own hook ``loop.mixup_draw``.  The port's
step runs SGD at lr 0, so its gradients stay readable.  Held at 1e-8
relative to each array's largest magnitude: the loss, every gradient (a
leaf the port leaves ``None`` is zero on the JAX side), the BatchNorm
statistics after the step (JAX's ``new_ms``: the clean forward's), and the
PGD example ``x_adv`` (the JAX package's, read where it passes
``lax.stop_gradient``).  The JAX package casts the logits to float32
before its loss; the port keeps float64 logits, so the float64 runs give
the JAX side's module a ``jnp`` whose ``float32`` is ``float64``
(``monkeypatch``).  A sign that flips between the two libraries' PGD
gradients moves an element of ``x_adv`` by 2 adv_alpha, so the ``x_adv``
gate also counts flips: the test reports them, and none was met.

Mixed precision runs in bf16 on both sides, and a narrow bf16 forward is
far from smooth (``tests/test_torch_train_loop.py``: gradients 0.4-1.0
apart between the libraries).  There the loss is held to the JAX
package's 10 % (``tests/test_mixed_precision.py``), the gradients to the
same leaves, finite, and ``x_adv`` to the epsilon box, with the share of
PGD signs the two agree on printed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aasist_tpu.train.loop as jax_loop
from aasist_tpu.registry import build_model as jax_build_model
from aasist_tpu.train.losses import am_softmax as jax_am_softmax
from aasist_tpu.train.losses import weighted_cce as jax_weighted_cce

from aasist_tpu_torch.config import OptimConfig, load_config
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.train import loop
from aasist_tpu_torch.train.loop import RobustOptions, make_train_step
from aasist_tpu_torch.train.losses import am_softmax, weighted_cce
from aasist_tpu_torch.train.optim import create_optimizer, make_schedule
from aasist_tpu_torch.weights import load_jax_params

from test_torch_train_models import (NARROW, _f64, _flat,  # noqa: F401
                                     one_torch_thread)
from test_torch_zoo_models import seeded_tree

TOL = 1e-8
CONF, LENGTH, _ = NARROW["AASIST"]
BATCH = 4
LAM = 0.3137
PERM = [2, 0, 3, 1]
ALMFT = dict(scale=15.0, margin=0.2, margin_a=0.06, margin_b=0.14)
# name -> (RobustOptions kwargs, ALMFT durations, grad_accum_steps, bf16)
VARIANTS = {
    "baseline": ({}, False, 1, False),
    "mixup": ({"use_mixup": True}, False, 1, False),
    "pgd": ({"adv_training": True}, False, 1, False),
    "mixup_pgd": ({"use_mixup": True, "adv_training": True}, False, 1,
                  False),
    "mixup_almft": ({"use_mixup": True}, True, 1, False),
    "grad_accum_2": ({"use_mixup": True, "adv_training": True}, False, 2,
                     False),
    "mixed_precision": ({"use_mixup": True, "adv_training": True}, False,
                        1, True),
}


class _F64Numpy:
    """``jax.numpy`` whose ``float32`` is ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


class _DropoutOff:
    """A JAX model whose ``apply`` runs with the dropouts off."""

    def __init__(self, model):
        self.model = model

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, dropout=False, **kwargs)


def _batch():
    rng = np.random.default_rng(17)
    return (rng.standard_normal((BATCH, LENGTH)) * 0.05,
            np.array([1, 0, 0, 1], np.int64), rng.uniform(1.0, 6.0, BATCH))


def _jax_side(name, monkeypatch):
    """(loss, {grad name: array}, {stat name: array}, x_adv list) of the
    JAX package's loss and gradients, microbatch by microbatch."""
    kw, almft, accum, bf16 = VARIANTS[name]
    robust = jax_loop.RobustOptions(**kw)
    n = BATCH // accum
    monkeypatch.setattr(jax_loop, "_mixup_draw", lambda rng, a, m: (
        jnp.asarray(LAM), jnp.asarray(PERM[:m] if m == BATCH
                                      else [1, 0][:m])))
    seen = []
    real_stop = jax.lax.stop_gradient

    def stop_gradient(a):
        if getattr(a, "shape", None) == (n, LENGTH):
            jax.debug.callback(lambda v: seen.append(np.asarray(v)), a)
        return real_stop(a)
    monkeypatch.setattr(jax.lax, "stop_gradient", stop_gradient)
    if not bf16:
        # the JAX package scores f32 logits (``batch_loss``: astype
        # float32); the port keeps float64 logits, so the reference does too
        monkeypatch.setattr(jax_loop, "jnp", _F64Numpy())

    if almft:
        def loss_fn(lg, y, d):
            return jax_am_softmax(lg, y, durations=d, **ALMFT)
    else:
        def loss_fn(lg, y, d):
            return jax_weighted_cce(lg, y)
    x, y, d = _batch()
    jm = jax_build_model({**CONF, "dtype": "float32" if bf16 else "float64"})
    params, state = seeded_tree(jm, np.random.default_rng(23))
    cast = (lambda t: t) if bf16 else _f64
    params, state = cast(params), cast(state)
    model = jm
    if bf16:
        from aasist_tpu.nn import with_compute_dtype
        model = with_compute_dtype(jm, jnp.bfloat16)
    dtype = np.float32 if bf16 else np.float64
    losses, grads, ms = [], [], state
    with jax.enable_x64(not bf16):
        micro = jax.jit(jax_loop._make_loss_and_grads(
            _DropoutOff(model), loss_fn, freq_aug=False, use_duration=almft,
            robust=robust, mixed_precision=bf16))
        for i in range(accum):
            sl = slice(i * n, (i + 1) * n)
            (loss, (_, ms)), g = micro(
                params, ms, jnp.asarray(x[sl], dtype), jnp.asarray(y[sl]),
                jnp.asarray(d[sl], dtype), jax.random.PRNGKey(i))
            losses.append(float(loss))
            grads.append(_flat(g))
        jax.effects_barrier()
    grad = {k: sum(g[k] for g in grads) / accum for k in grads[0]}
    return (np.mean(losses), grad, _flat(ms, rename_state=True), seen,
            params, state)


def _port_side(name, params, state, monkeypatch):
    """The port's (loss, {grad}, {statistics}, x_adv list) on the JAX
    side's weights."""
    kw, almft, accum, bf16 = VARIANTS[name]
    monkeypatch.setattr(loop, "mixup_draw", lambda key, a, m: (
        LAM, torch.tensor(PERM[:m] if m == BATCH else [1, 0][:m])))
    seen = []
    real_pgd = loop.pgd

    def pgd(*args):
        out = real_pgd(*args)
        seen.append(out.detach().numpy())
        return out
    monkeypatch.setattr(loop, "pgd", pgd)
    model = build_model(CONF)
    model = (model if bf16 else model.double())
    model = load_jax_params(model, params, state).train()
    cfg = OptimConfig.from_dict({"optimizer": "sgd", "base_lr": 0.0,
                                 "scheduler": "none"})
    if almft:
        def loss_fn(lg, y, d):
            return am_softmax(lg, y, durations=d, **ALMFT)
    else:
        def loss_fn(lg, y, d):
            return weighted_cce(lg, y)
    step = make_train_step(
        model, loss_fn, create_optimizer(cfg, model.parameters()),
        make_schedule(cfg), seed=0, freq_aug=False, use_duration=almft,
        grad_accum_steps=accum, mixed_precision=bf16, dropout=False,
        robust=RobustOptions(**kw))
    dtype = torch.float32 if bf16 else torch.float64
    x, y, d = _batch()
    loss, _ = step(torch.from_numpy(x).to(dtype), torch.from_numpy(y),
                   torch.from_numpy(d).to(dtype), 0)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()
             if p.grad is not None}
    stats = {k: b.numpy() for k, b in model.named_buffers()
             if "running" in k}
    return float(loss), grads, stats, seen


def _gate(label, got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want),
                       initial=0.0))
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    assert err <= tol * scale, f"{label}: max|diff| {err:.3e}"


@pytest.mark.parametrize("name", list(VARIANTS))
def test_robust_step_matches_jax(name, monkeypatch):
    kw, _, _, bf16 = VARIANTS[name]
    robust = RobustOptions(**kw)
    j_loss, j_grads, j_stats, j_adv, params, state = _jax_side(
        name, monkeypatch)
    p_loss, p_grads, p_stats, p_adv = _port_side(name, params, state,
                                                 monkeypatch)
    assert len(p_adv) == len(j_adv) == (
        VARIANTS[name][2] if robust.adv_training else 0)
    for got, want in zip(p_adv, j_adv):
        assert got.dtype == np.dtype("float32" if bf16 else "float64")
        flips = int((np.abs(got - want) > robust.adv_alpha).sum())
        assert np.abs(got - want).max() <= 2 * robust.adv_epsilon + 1e-6
        if bf16:
            agree = float((np.sign(got - want) == 0).mean())
            print(f"{name}: x_adv equal in {agree:.3f} of the elements")
        else:
            print(f"{name}: {flips} PGD sign flips")
            _gate(f"{name} x_adv", got, want)
    zeros = {k for k, v in j_grads.items() if not np.any(v)}
    assert set(p_grads) == set(j_grads) - zeros or set(p_grads) == set(
        j_grads)
    if bf16:
        assert p_loss == pytest.approx(j_loss, rel=0.1)
        assert all(np.isfinite(g).all() for g in p_grads.values())
        return
    _gate(f"{name} loss", p_loss, j_loss)
    for k, want in j_grads.items():
        _gate(f"{name} grad {k}", p_grads.get(k, np.zeros_like(want)), want)
    for k, want in j_stats.items():
        _gate(f"{name} stat {k}", p_stats[k], want)


def _model_and_batch():
    jm = jax_build_model({**CONF, "dtype": "float64"})
    params, state = seeded_tree(jm, np.random.default_rng(23))
    model = load_jax_params(build_model(CONF).double(), _f64(params),
                            _f64(state))
    x, y, d = _batch()
    return model, torch.from_numpy(x), torch.from_numpy(y), \
        torch.from_numpy(d)


def test_robust_step_moves_statistics_by_the_clean_forward_alone():
    """The BatchNorm statistics after a PGD step are those of the same step
    without PGD, bit for bit: the PGD and adversarial forwards move none."""
    after = {}
    for adv in (False, True):
        model, x, y, d = _model_and_batch()
        model.train()
        cfg = OptimConfig.from_dict({"optimizer": "sgd", "base_lr": 0.0,
                                     "scheduler": "none"})
        step = make_train_step(
            model, lambda lg, yy, dd: weighted_cce(lg, yy),
            create_optimizer(cfg, model.parameters()), make_schedule(cfg),
            seed=0, freq_aug=True, use_duration=False,
            robust=RobustOptions(adv_training=adv))
        step(x, y, d, 0)
        after[adv] = {k: b.clone() for k, b in model.named_buffers()}
    for k, v in after[False].items():
        assert torch.equal(after[True][k], v), k
    assert int(after[True]["first_bn.num_batches_tracked"]) == 1


def test_pgd_is_bounded_and_raises_the_loss():
    """The PGD example stays in the epsilon box and does not lower the
    eval-mode loss it attacks (``tests/test_robust_training.py``), and no
    parameter's gradient moves."""
    model, x, y, _ = _model_and_batch()
    model.eval()
    robust = RobustOptions(adv_training=True)

    def loss_of(xb):
        return weighted_cce(model(xb)[1], y)

    x_adv = loop.pgd(loss_of, x, robust)
    assert float((x_adv - x).abs().max()) <= robust.adv_epsilon + 1e-12
    assert float((x_adv - x).abs().max()) > 0
    with torch.no_grad():
        assert float(loss_of(x_adv)) >= float(loss_of(x))
    assert all(p.grad is None for p in model.parameters())


def test_robust_options_from_config(tmp_path):
    path = tmp_path / "robust.conf"
    path.write_text(
        '{"database_path": "./LA/", "model_config": {}, '
        '"optim_config": {}, "use_mixup": true, "mixup_alpha": 0.4, '
        '"adv_training": "True", "adv_epsilon": 0.05, "adv_steps": 5}')
    r = RobustOptions.from_config(load_config(path))
    assert r.use_mixup and r.adv_training
    assert (r.mixup_alpha, r.adv_epsilon, r.adv_steps) == (0.4, 0.05, 5)
    assert (r.adv_alpha, r.adv_ratio) == (0.01, 0.5)
    d = RobustOptions.from_config(load_config(
        "aasist_tpu_torch/configs/AASIST.conf"))
    assert d == RobustOptions() and not (d.use_mixup or d.adv_training)
    assert (d.mixup_alpha, d.adv_epsilon, d.adv_alpha, d.adv_steps,
            d.adv_ratio) == (0.3, 0.02, 0.01, 3, 0.5)


def test_mixup_draw_is_keyed():
    lam, perm = loop.mixup_draw((2, 3, 0, 0, 1), 0.3, 6)
    lam2, perm2 = loop.mixup_draw((2, 3, 0, 0, 1), 0.3, 6)
    assert lam == lam2 and torch.equal(perm, perm2)
    assert 0.0 < lam < 1.0 and sorted(perm.tolist()) == list(range(6))
    assert loop.mixup_draw((2, 4, 0, 0, 1), 0.3, 6)[0] != lam


def test_robust_step_draws_from_its_keyed_streams(monkeypatch):
    """A robust microbatch's forwards draw from fresh streams: the clean
    one keyed (seed + 1, step, microbatch), every PGD step and the
    adversarial loss one keyed that + (0, 2), each from its first draw;
    mixup's draw is keyed that + (0, 1)."""
    from aasist_tpu_torch import nn

    made, mixed = [], []
    real_stream = nn.RngStream

    class Stream(real_stream):
        def __init__(self, key, *args, **kwargs):
            super().__init__(key, *args, **kwargs)
            made.append(self)

    monkeypatch.setattr(nn, "RngStream", Stream)
    real_draw = loop.mixup_draw

    def draw(key, alpha, n):
        mixed.append(key)
        return real_draw(key, alpha, n)
    monkeypatch.setattr(loop, "mixup_draw", draw)
    model, x, y, d = _model_and_batch()
    model.train()
    cfg = OptimConfig.from_dict({"optimizer": "sgd", "base_lr": 0.0,
                                 "scheduler": "none"})
    robust = RobustOptions(use_mixup=True, adv_training=True, adv_steps=2)
    step = make_train_step(
        model, lambda lg, yy, dd: weighted_cce(lg, yy),
        create_optimizer(cfg, model.parameters()), make_schedule(cfg),
        seed=4, freq_aug=True, use_duration=False, robust=robust)
    step(x, y, d, 7)
    key = (5, 7, 0)
    assert mixed == [key + (0, 1)]
    assert [s.key for s in made] == [key] + [key + (0, 2)] * 3
    assert len({id(s) for s in made}) == 4
    # each stream drew the same sequence of generators from its first
    assert len({s.count for s in made}) == 1 and made[0].count > 0
