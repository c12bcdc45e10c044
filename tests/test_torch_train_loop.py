"""The port's training machinery on the CPU: mixed precision, the bn1 rule,
SWA and BatchNorm re-estimation, the train-state checkpoints, and the
training keys of the config, each against the JAX package where it has a
counterpart.

Mixed precision keeps float32 masters and statistics, comes within the
JAX package's bound of the float32 loss (``tests/test_mixed_precision.py``:
10 % relative), and is the JAX package's bf16 step: BatchNorm's weights
and statistics cast to bf16 too, the new statistics carried back in f32.  bn1, whose output the residual blocks discard, keeps its
weights and gets no optimizer state in every mode (f32, bf16, accumulated),
while its running statistics move.  The re-estimated statistics of every
BatchNorm upstream of the first dropout equal the JAX package's
``reestimate_bn_stats`` at f32 tolerance (1e-5 relative: the same batches
through the same math in another library's f32 order), and on a
dropout-free model they are the mean of the batches' statistics, averaged
in f32 in either precision.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax

from aasist_tpu.config import load_config as jax_load_config
from aasist_tpu.registry import build_model as jax_build_model
from aasist_tpu.train.swa import reestimate_bn_stats as jax_reestimate
from aasist_tpu.utils.pytree_io import load_tree_npz as jax_load_tree_npz

from aasist_tpu_torch import nn
from aasist_tpu_torch.config import OptimConfig, load_config
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.train import checkpoints as ck
from aasist_tpu_torch.train.loop import make_train_step
from aasist_tpu_torch.train.losses import weighted_cce
from aasist_tpu_torch.train.optim import create_optimizer, make_schedule
from aasist_tpu_torch.train.swa import SWAState, reestimate_bn_stats
from aasist_tpu_torch.weights import load_jax_params, load_npz, save_npz

from test_torch_train_models import _flat, one_torch_thread  # noqa: F401
from test_torch_zoo_models import seeded_tree

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = {
    "architecture": "AASIST", "first_conv": 128,
    "filts": [70, [1, 4], [4, 4], [4, 8], [8, 8]],
    "gat_dims": [8, 12], "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}


def _batch(seed=0, length=16000):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy((rng.standard_normal((4, length)) * 0.05)
                             .astype(np.float32)),
            torch.tensor([0, 1, 0, 1]), torch.ones(4))


def _step(model, mp=False, accum=1, opt="adam"):
    cfg = OptimConfig.from_dict({"optimizer": opt, "base_lr": 1e-3,
                                 "scheduler": "none"})
    optimizer = create_optimizer(cfg, model.parameters())
    return optimizer, make_train_step(
        model, lambda lg, y, d: weighted_cce(lg, y), optimizer,
        make_schedule(cfg), seed=3, freq_aug=True, use_duration=False,
        grad_accum_steps=accum, mixed_precision=mp)


def test_mixed_precision_step_keeps_f32_masters():
    torch.manual_seed(0)
    model = build_model(TINY).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, step = _step(model, mp=True)
    loss, _ = step(*_batch(), 0)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for k, v in model.state_dict().items():
        assert v.dtype == before[k].dtype, k
    assert any(not torch.equal(v, before[k])
               for k, v in model.named_parameters())
    assert not torch.equal(model.first_bn.running_mean,
                           before["first_bn.running_mean"])


@functools.lru_cache(maxsize=None)
def _jax_init_model():
    """TINY with the JAX package's own initial weights (``init`` at
    PRNGKey(0)), the weights ``tests/test_mixed_precision.py`` holds its
    bf16 bound on, and its JAX model."""
    jm = jax_build_model(TINY)
    params, state = jm.init(jax.random.PRNGKey(0))
    return jm, params, state


def test_mixed_precision_loss_close_to_f32():
    """The bf16 step's loss within the JAX package's 10 % of the f32
    step's, on the weights and input of ``tests/test_mixed_precision.py``.
    (A bf16 forward of this narrow model is far from smooth: the graph
    pools keep the top-k nodes, and a score that rounds past its neighbour
    swaps a node.  Over the JAX initial weights at PRNGKey(0..5) the step
    reads 1.0e-2 to 6.6e-2; under torch's default initial weights some
    seeds read 0.48.)"""
    _, params, state = _jax_init_model()
    losses = []
    for mp in (False, True):
        m = load_jax_params(build_model(TINY), params, state).train()
        losses.append(float(_step(m, mp=mp)[1](*_batch(), 0)[0]))
    assert losses[1] == pytest.approx(losses[0], rel=0.1)
    assert losses[1] != losses[0]


class _DropoutOff:
    """A JAX model whose ``apply`` runs with the dropouts off."""

    def __init__(self, model):
        self.model = model

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, dropout=False, **kwargs)


def test_mixed_precision_step_matches_jax():
    """One bf16 forward and backward against the JAX package's
    ``_make_loss_and_grads(mixed_precision=True)`` on the same weights and
    batch, dropout off.  Both cast every f32 parameter and statistic to
    bf16, BatchNorm's included, and carry the new statistics back in f32.
    The port's are bf16 values (XLA may keep the JAX package's in excess
    precision, so its are not held to that); those of first_bn and the
    encoder, upstream of the graph pools' top-k, are within 3e-2 relative
    of the JAX package's (read: 6.4e-3; 2^-8 is one bf16 ulp, and bf16
    against f32 reads up to 1.8e-2 on either side).  The loss
    is held to the JAX package's 10 % (read: 4.4e-2).  The gradients of
    this narrow model are as far apart between the two libraries as each
    library's bf16 is from its f32 (0.4 to 1.0 in relative norm over four
    seeds), so only their leaves are held: the same leaves, finite, the
    port's discarded bn1 ``None`` where the JAX package's is zero."""
    from aasist_tpu.nn import with_compute_dtype
    from aasist_tpu.train.loop import RobustOptions, _make_loss_and_grads
    from aasist_tpu.train.losses import weighted_cce as jax_weighted_cce

    from aasist_tpu_torch.train.loop import forward_fn

    jm, params, state = _jax_init_model()
    x, y, _ = _batch()
    run = jax.jit(_make_loss_and_grads(
        _DropoutOff(with_compute_dtype(jm, jax.numpy.bfloat16)),
        lambda lg, yy, d: jax_weighted_cce(lg, yy), freq_aug=False,
        use_duration=False, robust=RobustOptions(), mixed_precision=True))
    (want_loss, (_, new_state)), want_grads = run(
        params, state, x.numpy(), y.numpy(), None, jax.random.PRNGKey(0))
    want_stats = _flat(new_state, rename_state=True)
    want_grads = _flat(want_grads)

    model = load_jax_params(build_model(TINY), params, state).train()
    logits = forward_fn(model, mixed_precision=True)(
        x, nn.RngStream(None, dropout_enabled=False), False)[1]
    loss = weighted_cce(logits.float(), y)
    loss.backward()

    assert float(loss) == pytest.approx(float(want_loss), rel=0.1)
    bufs = dict(model.named_buffers())
    upstream = [k for k in want_stats
                if k.split(".")[0] in ("first_bn", "encoder")]
    assert len(upstream) == 2 + 2 * (6 + 5)
    for k in upstream:
        got, want = bufs[k], torch.from_numpy(want_stats[k])
        assert got.dtype == torch.float32, k
        assert torch.equal(got, got.bfloat16().float()), k
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 3e-2, f"{k}: {err:.3e}"
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want_grads)
    for n, g in grads.items():
        if g is None:
            assert ".bn1." in n and not np.any(want_grads[n]), n
        else:
            assert g.dtype == torch.float32 and torch.isfinite(g).all(), n


@pytest.mark.parametrize("mp,accum,opt", [
    (False, 1, "adam"), (True, 1, "adam"), (False, 2, "adam"),
    (True, 2, "sgd")])
def test_bn1_is_untouched_and_stateless(mp, accum, opt):
    """Three steps: the discarded bn1's weight and bias stay as they were
    and have no optimizer state (torch skips a None gradient: no moments,
    no decay); its running statistics move, as the reference's do."""
    torch.manual_seed(1)
    model = build_model(TINY).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, step = _step(model, mp=mp, accum=accum, opt=opt)
    for i in range(3):
        step(*_batch(i), i)
    bn1 = {n: p for n, p in model.named_parameters() if ".bn1." in n}
    assert len(bn1) == 10
    for n, p in bn1.items():
        assert p.grad is None and p not in optimizer.state, n
        assert torch.equal(p.detach(), before[n]), n
    assert not torch.equal(model.encoder[1].bn1.running_mean,
                           before["encoder.1.bn1.running_mean"])
    assert all(p in optimizer.state for n, p in model.named_parameters()
               if n not in bn1)


def test_swa_running_average():
    swa = SWAState()
    for w in (1.0, 3.0, 5.0):
        swa.update({"w": torch.tensor([w, 2 * w])})
    assert swa.n == 3
    torch.testing.assert_close(swa.avg["w"], torch.tensor([3.0, 6.0]))


def test_reestimated_stats_match_jax():
    """Two batches through the JAX package's ``reestimate_bn_stats`` and
    the port's: first_bn and every encoder BatchNorm (bn1 included) are
    upstream of the first dropout; the graph layers' are downstream (their
    inputs differ by the dropout draws) and only moved."""
    jm = jax_build_model(TINY)
    params, state = seeded_tree(jm, np.random.default_rng(5))
    model = load_jax_params(build_model(TINY), params, state)
    rng = np.random.default_rng(6)
    batches = [(rng.standard_normal((4, 12000)) * 0.2).astype(np.float32)
               for _ in range(2)]
    want = _flat(jax_reestimate(jm, params, state, iter(batches)),
                 rename_state=True)
    reestimate_bn_stats(model, [(torch.from_numpy(b),) for b in batches])
    assert not model.training
    bufs = dict(model.named_buffers())
    upstream = [k for k in want if k.split(".")[0] in ("first_bn",
                                                        "encoder")]
    assert len(upstream) == 2 + 2 * (6 + 5)      # first_bn, bn2s, bn1s
    for k in upstream:
        np.testing.assert_allclose(bufs[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert not np.allclose(bufs["GAT_layer_S.bn.running_mean"].numpy(),
                           _flat(state, rename_state=True)[
                               "GAT_layer_S.bn.running_mean"])


def test_reestimate_is_the_cumulative_average():
    """RawNet2 has no dropout: every statistic is the mean over the
    batches of that batch's own (unbiased variance), the momenta are
    restored after, and the bf16 pass stays f32 and close."""
    conf = {"architecture": "RawNet2Spoof", "first_conv": 128,
            "filts": [20, [20, 20], [20, 16], [16, 16]], "gru_node": 16,
            "nb_gru_layer": 1, "nb_fc_node": 16, "nb_classes": 2}
    torch.manual_seed(2)
    model = build_model(conf)
    rng = np.random.default_rng(7)
    batches = [torch.from_numpy((rng.standard_normal((3, 8000)) * (i + 1))
                                .astype(np.float32)) for i in range(3)]
    per_batch = []
    for b in batches:
        m = build_model(conf)
        m.load_state_dict(model.state_dict())
        m.train()
        for bn in m.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                bn.momentum = 1.0
        with torch.no_grad():
            m(b, rngs=nn.RngStream((0,)))
        per_batch.append({k: v.clone() for k, v in m.named_buffers()
                          if "running" in k})
    reestimate_bn_stats(model, batches)
    for k, v in model.named_buffers():
        if "running" in k:
            want = torch.stack([p[k] for p in per_batch]).mean(0)
            torch.testing.assert_close(v, want, rtol=1e-5, atol=1e-6)
    assert all(bn.momentum == 0.1 for bn in model.modules()
               if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm))
    f32 = model.first_bn.running_mean.clone()
    reestimate_bn_stats(model, batches, mixed_precision=True)
    assert model.first_bn.running_mean.dtype == torch.float32
    torch.testing.assert_close(model.first_bn.running_mean, f32, rtol=5e-2,
                               atol=5e-3)


def _trained(tmp_path):
    torch.manual_seed(4)
    model = build_model(TINY).train()
    optimizer, step = _step(model)
    swa = SWAState()
    for i in range(2):
        step(*_batch(i), i)
        swa.update(dict(model.named_parameters()))
    return model, optimizer, swa


def test_train_state_round_trip(tmp_path):
    model, optimizer, swa = _trained(tmp_path)
    meta = {"step": 2, "epoch": 0, "best_dev_eer": 12.5,
            "best_eval_eer": 20.0, "best_eval_tdcf": 0.5}
    ck.save_train_state(tmp_path / "st", model, optimizer, swa, meta)
    other = build_model(TINY).train()
    opt2, _ = _step(other)
    swa2 = SWAState()
    got = ck.load_train_state(tmp_path / "st", other, opt2, swa2)
    assert got == {**meta, "n_swa": 2, "has_swa": True}
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(other.state_dict()[k], v), k
    names = dict(other.named_parameters())
    for n, p in model.named_parameters():
        for key, v in optimizer.state[p].items():
            assert torch.equal(opt2.state[names[n]][key], v), (n, key)
    assert swa2.n == 2
    for k, v in swa.avg.items():
        assert torch.equal(swa2.avg[k], v), k


def test_train_state_survives_a_crash_between_the_renames(tmp_path,
                                                          monkeypatch):
    """A crash after the old state moved aside leaves ``.old``, which the
    load reads; a save in that state keeps ``.old`` until its own primary
    is in place."""
    model, optimizer, swa = _trained(tmp_path)
    d = tmp_path / "st"
    ck.save_train_state(d, model, optimizer, swa, {"step": 1, "epoch": 0})
    ck.save_train_state(d, model, optimizer, swa, {"step": 2, "epoch": 1})
    assert not d.with_name("st.old").exists()
    os.replace(d, d.with_name("st.old"))
    assert ck.load_train_state(d, model, optimizer, swa)["step"] == 2
    real = os.replace

    def crash(src, dst):
        if str(dst) == str(d):
            raise RuntimeError("crash before the final rename")
        return real(src, dst)

    monkeypatch.setattr(ck.os, "replace", crash)
    with pytest.raises(RuntimeError):
        ck.save_train_state(d, model, optimizer, swa, {"step": 3,
                                                       "epoch": 2})
    monkeypatch.setattr(ck.os, "replace", real)
    assert ck.load_train_state(d, model, optimizer, swa)["step"] == 2
    ck.save_train_state(d, model, optimizer, swa, {"step": 3, "epoch": 2})
    assert ck.load_train_state(d, model, optimizer, swa)["step"] == 3
    assert not d.with_name("st.old").exists()


def test_weight_snapshot_reads_in_both_packages(tmp_path):
    """A port-trained snapshot loads into the port and, through the JAX
    package's ``load_tree_npz``, into the JAX model: the same logits."""
    model, _, _ = _trained(tmp_path)
    model.eval()
    save_npz(model, tmp_path / "best.npz")
    port = load_npz(build_model(TINY), tmp_path / "best.npz")
    x = _batch(9)[0]
    with torch.no_grad():
        want = model(x)[1].numpy()
        got = port(x)[1].numpy()
    np.testing.assert_array_equal(got, want)
    params, state = jax_load_tree_npz(tmp_path / "best.npz")
    jm = jax_build_model(TINY)
    (_, jl), _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False))(
        params, state, x.numpy())
    np.testing.assert_allclose(np.asarray(jl), want, atol=1e-4, rtol=0)


def test_training_keys_are_the_jax_packages():
    for name in sorted(os.listdir(os.path.join(ROOT, "configs"))):
        path = os.path.join(ROOT, "configs", name)
        got, want = load_config(path), jax_load_config(path)
        for key in ("loss", "eval_all_best", "freq_aug", "am_softmax_scale",
                    "adaptive_margin", "margin_a", "margin_b", "margin"):
            assert getattr(got, key) == getattr(want, key), (name, key)
        assert (vars(got.optim_config) == vars(want.optim_config)), name
        assert (vars(got.dynamic_chunk) == vars(want.dynamic_chunk)), name
        for key in ("mixed_precision", "grad_accum_steps", "train_chain",
                    "label_smoothing", "use_mixup", "adv_training"):
            assert got.extras.get(key) == want.extras.get(key), (name, key)

