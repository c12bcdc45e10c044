"""The port's train step against the JAX package's, float64, on the CPU:
AASIST (AASIST2's Res2Net encoder: ``tests/test_torch_train_res2net.py``;
AASIST-Robust and RawNet2: ``tests/test_torch_train_zoo.py``; RawGAT-ST:
``tests/test_torch_train_rawgat.py``).

Narrow models (20 sinc channels, 8,000 samples; RawGAT-ST 70 and 64,600,
which its projections fix), seeded weights in the JAX model's tree carried
in by ``load_jax_params``, the same numpy batches.  The port runs its own
``train/loop.py:make_train_step`` with dropout off (BatchNorm in train
mode), the JAX side ``model.apply(train=True, dropout=False)`` under a
jitted ``jax.value_and_grad`` and the package's ``create_optimizer``, all
in float64 (``jax.enable_x64``).  Each of two steps is held at 1e-10 as a
function of the same inputs (the JAX side starts each step from the
port's parameters and statistics: Adam divides by sqrt(v) + 1e-8, so a
leaf whose gradient is near 1e-8 turns rounding into ~5e-11 of parameter,
which a deep forward grows to ~3e-8 of logits a step later): the loss,
every gradient (a leaf whose gradient is ``None`` on the port's side, the
discarded bn1 and the heads the train forward does not reach, is zero on
the JAX side), the BatchNorm statistics after the step and the parameters
after it, for Adam, Adam with AMSGrad, SGD with Nesterov momentum, and two
accumulated microbatches; and the train-mode logits and each loss on them.

The JAX optimizer is masked to the leaves the port's step gives a
gradient: torch's optimizers skip a ``None`` gradient (no moments, no
decay), which the JAX package mirrors with ``grad_mask`` for bn1 only.
optax's AMSGrad keeps the running maximum of the bias-corrected second
moment, torch's (the reference's) of the raw one, so from the second step
on the two differ wherever a gradient shrinks: the port's second AMSGrad
step is held to torch's rule (``_torch_amsgrad``) on the JAX package's
gradients.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import optax

from aasist_tpu.config import OptimConfig as JaxOptimConfig
from aasist_tpu.registry import build_model as jax_build_model
from aasist_tpu.train.losses import am_softmax as jax_am_softmax
from aasist_tpu.train.losses import weighted_cce as jax_weighted_cce
from aasist_tpu.train.optim import create_optimizer as jax_create_optimizer

from aasist_tpu_torch.config import OptimConfig
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.train.loop import make_train_step
from aasist_tpu_torch.train.losses import am_softmax, weighted_cce
from aasist_tpu_torch.train.optim import create_optimizer, make_schedule
from aasist_tpu_torch.utils.pytree_io import flatten_tree
from aasist_tpu_torch.weights import load_jax_params

from test_torch_zoo_models import seeded_tree

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module (restored after): the suite runs
    six workers on eight cores, and under torch's default of a thread a
    core these small ops wait on descheduled threads (on 8 CPU cores the
    port's test files took 557.6 s so under six workers, 350.4 s with the
    train modules on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_GRAPH = {"gat_dims": [12, 16], "pool_ratios": [0.5, 0.7, 0.5, 0.5],
          "temperatures": [2.0, 2.0, 100.0, 100.0], "remat": False}
# arch -> (model config, input length, batch)
NARROW = {
    "AASIST": ({"architecture": "AASIST", "first_conv": 128,
                "filts": [20, [1, 8], [8, 8], [8, 12], [12, 12]], **_GRAPH},
               8000, 4),
    "AASIST2": ({"architecture": "AASIST2", "first_conv": 128,
                 # four splits of four channels, the carry at split 2
                 "filts": [20, [1, 16], [16, 16], [16, 16], [16, 16]],
                 "res2net_width": 4, "res2net_scale": 2, **_GRAPH},
                8000, 4),
    "AASIST_Robust": ({"architecture": "AASIST_Robust", "first_conv": 128,
                       "filts": [20, [1, 8], [8, 8], [8, 12], [12, 12]],
                       "gat_dims": [12, 16],
                       "pool_ratios": [0.4, 0.5, 0.7, 0.5],
                       "temperatures": [2.0, 2.0, 100.0, 50.0],
                       # the noise's draw is the port's own (its own test)
                       "noise_sigma": 0.0}, 8000, 4),
    "RawNetGatSpoofST": ({"architecture": "RawNetGatSpoofST",
                          "first_conv": 128,
                          "filts": [70, [1, 4], [4, 4], [4, 8], [8, 8]]},
                         64600, 2),
    "RawNet2Spoof": ({"architecture": "RawNet2Spoof", "first_conv": 128,
                      "filts": [20, [20, 20], [20, 16], [16, 16]],
                      "gru_node": 16, "nb_gru_layer": 2, "nb_fc_node": 16,
                      "nb_classes": 2}, 8000, 4),
}
# a constant lr: inside optax the JAX package's cosine schedule comes out in
# float32 (1e-3 reads 0.0010000000475), 5e-8 of an SGD step; the schedules
# are held to the reference's trajectories in test_torch_train_goldens.py
OPTIM = {"base_lr": 1e-3, "weight_decay": 1e-3, "scheduler": "none"}
OPTIMIZERS = {
    "adam": {"optimizer": "adam"},
    "amsgrad": {"optimizer": "adam", "amsgrad": True},
    "sgd_nesterov": {"optimizer": "sgd", "momentum": 0.9, "nesterov": True},
}


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _batches(length, n=2, batch=4):
    rng = np.random.default_rng(41)
    return [((rng.standard_normal((batch, length)) * 0.05),
             np.array(([1, 0] if i == 0 else [0, 1]) * (batch // 2),
                      np.int64),
             rng.uniform(1.0, 6.0, batch)) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _case(arch):
    """(JAX model, f64 params, f64 state, its jitted loss-and-grads)."""
    conf = NARROW[arch][0]
    jm = jax_build_model({**conf, "dtype": "float64"})
    params, state = seeded_tree(jm, np.random.default_rng(23))
    params, state = _f64(params), _f64(state)

    def loss_fn(p, s, x, y, d):
        (_, logits), ns = jm.apply(p, s, x, train=True, dropout=False)
        return jax_weighted_cce(logits, y), (logits, ns)

    with jax.enable_x64(True):
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return jm, params, state, vg


def _port(arch, params, state):
    model = build_model(NARROW[arch][0]).double()
    return load_jax_params(model, params, state).train()


def _flat(tree, rename_state=False):
    """{dotted port name: numpy array} of a JAX tree."""
    out = {}
    for k, v in flatten_tree(tree).items():
        k = k.replace("/", ".")
        if rename_state:
            head, _, leaf = k.rpartition(".")
            k = head + "." + {"mean": "running_mean",
                              "var": "running_var"}[leaf]
        out[k] = np.asarray(v)
    return out


def _close(label, got, want, tol=TOL):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= tol, f"{label}: max|diff| {err:.3e}"


def _mask(params, no_grad):
    """The JAX params tree's bool mask: False on the port's None-grad
    leaves."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(node)]
        return prefix[:-1] not in no_grad
    return walk(params, "")


def _torch_amsgrad(p, g, st, lr, t, b1=0.9, b2=0.999, eps=1e-8, wd=1e-3):
    """torch.optim.Adam(amsgrad=True)'s update of one leaf (numpy)."""
    g = g + wd * p
    st["m"] = b1 * st.get("m", 0.0) + (1 - b1) * g
    st["v"] = b2 * st.get("v", 0.0) + (1 - b2) * g * g
    st["vmax"] = np.maximum(st.get("vmax", 0.0), st["v"])
    denom = np.sqrt(st["vmax"]) / np.sqrt(1 - b2 ** t) + eps
    return p - lr / (1 - b1 ** t) * st["m"] / denom


def _port_trees(model, params, state):
    """The port model's parameters and statistics as JAX trees shaped like
    ``params`` / ``state``."""
    named = {**{n: t.detach().numpy() for n, t in model.named_parameters()},
             **{n: t.numpy() for n, t in model.named_buffers()}}

    def walk(node, prefix, rename):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}.", rename)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{prefix}{i}.", rename)
                    for i, v in enumerate(node)]
        name = prefix[:-1]
        if rename:
            head, _, leaf = name.rpartition(".")
            name = f"{head}.running_{leaf}"
        return named[name].copy()
    return walk(params, "", False), walk(state, "", True)


def _run(arch, opt_name, accum=1):
    """Two steps on each side, each from the port's parameters and
    statistics; checks what the module docstring lists.  Returns the
    names of the port's None-grad leaves."""
    jm, params, state, vg = _case(arch)
    model = _port(arch, params, state)
    cfg = OptimConfig.from_dict({**OPTIM, **OPTIMIZERS[opt_name]})
    schedule = make_schedule(cfg)
    optimizer = create_optimizer(cfg, model.parameters())
    step = make_train_step(
        model, lambda lg, y, d: weighted_cce(lg, y), optimizer, schedule,
        seed=0, freq_aug=False, use_duration=False,
        grad_accum_steps=accum, dropout=False)
    jcfg = JaxOptimConfig.from_dict({**OPTIM, **OPTIMIZERS[opt_name]})
    opt = opt_state = None
    ams = {}
    _, length, batch = NARROW[arch]
    for i, (x, y, d) in enumerate(_batches(length, batch=batch)):
        p, s = _port_trees(model, params, state)
        loss, _ = step(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(d), i)
        grads = {n: t.grad for n, t in model.named_parameters()}
        no_grad = {n for n, g in grads.items() if g is None}
        with jax.enable_x64(True):
            m = batch // accum
            gs, jloss = [], 0.0
            for j in range(accum):
                sl = slice(j * m, (j + 1) * m)
                (lj, (_, s)), gj = vg(p, s, x[sl], y[sl], d[sl])
                gs.append(gj)
                jloss += float(lj) / accum
            # numpy, not JAX ops: an eager op compiles once a leaf shape
            g = jax.tree_util.tree_map(
                lambda *a: sum(np.asarray(t) for t in a) / accum, *gs)
            if opt is None:
                opt = jax_create_optimizer(jcfg,
                                           grad_mask=_mask(params, no_grad))
                opt_state = jax.jit(opt.init)(p)

                @jax.jit
                def update(g, opt_state, p):
                    u, opt_state = opt.update(g, opt_state, p)
                    return optax.apply_updates(p, u), opt_state
            new_p, opt_state = update(g, opt_state, p)
            want_p = _flat(new_p)
        _close(f"{arch} loss {i}", float(loss), jloss)
        flat_g, flat_p = _flat(g), _flat(p)
        for name, want in flat_g.items():
            if grads[name] is None:
                assert not np.any(want), f"{name}: JAX grad not zero"
            else:
                _close(f"{arch} grad {i} {name}", grads[name].numpy(), want)
        bufs = dict(model.named_buffers())
        for name, want in _flat(s, rename_state=True).items():
            _close(f"{arch} BN {i} {name}", bufs[name].numpy(), want)
        if opt_name == "amsgrad":
            # torch's rule on the JAX package's gradients (docstring); its
            # first step is optax's too
            for name in want_p:
                if name not in no_grad:
                    got = _torch_amsgrad(flat_p[name], flat_g[name],
                                         ams.setdefault(name, {}),
                                         schedule(i), i + 1)
                    want_p[name] = got if i else want_p[name]
        for name, t in model.named_parameters():
            _close(f"{arch} {opt_name} param {i} {name}",
                   t.detach().numpy(), want_p[name])
    return no_grad


def test_train_steps_match_jax():
    """Two Adam steps; the residual blocks' bn1 gets no gradient
    (AASIST2's Res2Net encoder: tests/test_torch_train_res2net.py)."""
    no_grad = _run("AASIST", "adam")
    assert {n.split(".bn1.")[0] for n in no_grad} == {
        f"encoder.{i}" for i in range(1, 6)}


@pytest.mark.parametrize("opt_name", ["amsgrad", "sgd_nesterov"])
def test_optimizers_match_jax(opt_name):
    _run("AASIST", opt_name)


def test_train_forward_and_losses_match_jax():
    """The train-mode logits (dropout off) and the losses on them: weighted
    CCE, with label smoothing, AM-Softmax and ALMFT."""
    from aasist_tpu_torch import nn

    jm, params, state, vg = _case("AASIST")
    model = _port("AASIST", params, state)
    x, y, d = _batches(NARROW["AASIST"][1], 1)[0]
    logits = model(torch.from_numpy(x),
                   rngs=nn.RngStream(None, dropout_enabled=False))[1]
    with jax.enable_x64(True):
        (_, (jl, _)), _ = vg(params, state, x, y, d)
        want = {"cce": jax_weighted_cce(jl, y),
                "smooth": jax_weighted_cce(jl, y, label_smoothing=0.1),
                "ams": jax_am_softmax(jl, y, margin=0.25),
                "almft": jax_am_softmax(jl, y, margin=0.25, durations=d)}
        want = {k: float(v) for k, v in want.items()}
    _close("logits", logits.detach().numpy(), np.asarray(jl))
    yt, dt = torch.from_numpy(y), torch.from_numpy(d)
    got = {"cce": weighted_cce(logits, yt),
           "smooth": weighted_cce(logits, yt, label_smoothing=0.1),
           "ams": am_softmax(logits, yt, margin=0.25),
           "almft": am_softmax(logits, yt, margin=0.25, durations=dt)}
    for k in want:
        _close(k, float(got[k].detach()), want[k])


def test_remat_is_the_same_step():
    """``remat`` recomputes each encoder block in the backward: the same
    gradients, and the running statistics moved once, not twice."""
    _, params, state, _ = _case("AASIST")
    x, y, d = _batches(NARROW["AASIST"][1], 1)[0]
    out = []
    for remat in (False, True):
        model = _port("AASIST", params, state)
        model.remat = remat
        cfg = OptimConfig.from_dict({**OPTIM, "optimizer": "adam"})
        step = make_train_step(
            model, lambda lg, yy, dd: weighted_cce(lg, yy),
            create_optimizer(cfg, model.parameters()), make_schedule(cfg),
            seed=0, freq_aug=False, use_duration=False, dropout=False)
        step(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(d),
             0)
        out.append({k: v.clone() for k, v in model.state_dict().items()})
    for k, v in out[0].items():
        assert torch.equal(out[1][k], v), k
