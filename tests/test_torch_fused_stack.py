"""The port's frontend + block-0 pair (``aasist_tpu_torch/ops/fused_stack``)
against ``tools/fused_stack.py`` run in Pallas interpret mode, on the CPU.

Inputs and weights are made with numpy from a seed; block 0's weights and
BatchNorm statistics are moved off their init values and carried into the
port's modules by ``load_jax_params``.  The JAX module is imported from
``tools/`` through ``sys.path``, as ``tools/test_fused_stack.py`` does.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from aasist_tpu.models.layers import sinc_filterbank
from aasist_tpu.nn import BN_EPS

from aasist_tpu_torch.models.layers import ResidualBlock
from aasist_tpu_torch.ops import fused_stack as fs
from aasist_tpu_torch.ops.block0_pipe import block0_pipe
from aasist_tpu_torch.ops.frontend_variants import fused_frontend_dot_padded
from aasist_tpu_torch.config import load_config
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.serving import Scorer, kernel_route
from aasist_tpu_torch.weights import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools"))
import fused_stack as FS  # noqa: E402

C = 32


def _jax_params(seed):
    """Block 0 and first-BN trees, as ``tools/test_fused_stack.py`` makes
    them."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    p = {
        "conv1": {"weight": r.normal(0, 0.3, (C, 1, 2, 3)).astype(f32),
                  "bias": r.normal(0, 0.1, (C,)).astype(f32)},
        "conv2": {"weight": r.normal(0, 0.2, (C, C, 2, 3)).astype(f32),
                  "bias": r.normal(0, 0.1, (C,)).astype(f32)},
        "conv_downsample": {
            "weight": r.normal(0, 0.3, (C, 1, 1, 3)).astype(f32),
            "bias": r.normal(0, 0.1, (C,)).astype(f32)},
        "bn2": {"weight": 1.0 + 0.1 * r.normal(0, 1, (C,)).astype(f32),
                "bias": 0.1 * r.normal(0, 1, (C,)).astype(f32)},
    }
    s = {"bn2": {"mean": 0.05 * r.normal(0, 1, (C,)).astype(f32),
                 "var": (1.0 + 0.2 * r.random((C,))).astype(f32)}}
    fe_p = {"weight": np.asarray([1.3], f32), "bias": np.asarray([0.2], f32)}
    fe_s = {"mean": np.asarray([0.1], f32), "var": np.asarray([1.5], f32)}
    return p, s, fe_p, fe_s


def _port(p, s, fe_p, fe_s):
    """(block 0 module, first-BN weight dict, first-BN stats dict)."""
    block = load_jax_params(ResidualBlock(1, C, first=True), p, s)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (block.eval(), {k: t(v) for k, v in fe_p.items()},
            {k: t(v) for k, v in fe_s.items()})


@pytest.mark.parametrize("length,b", [(2400, 2), (4000, 3)])
def test_fused_frontend_block0_matches_jax(length, b):
    """The port's pair (plain route) against the Pallas pair, f32, at the
    JAX test's own gate: max error / max |ref| < 5e-5."""
    p, s, fe_p, fe_s = _jax_params(0)
    bank = sinc_filterbank(70, 129, 16000).astype(np.float32)
    x = np.random.default_rng(1).normal(0, 1, (b, length)).astype(np.float32)
    fsp = FS.FusedStackParams(bank, fe_p, fe_s, p, s, dtype=jnp.float32)
    ref = np.asarray(FS.fused_frontend_block0(jnp.asarray(x), fsp),
                     np.float32)

    block, bn_p, bn_s = _port(p, s, fe_p, fe_s)
    with torch.inference_mode():
        got = fs.fused_frontend_block0(torch.from_numpy(x),
                                       torch.from_numpy(bank), bn_p, bn_s,
                                       block).numpy()
    t_out = (length - 128) // 9
    assert got.shape == ref.shape == (b, C, 23, t_out)
    err = np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-6)
    assert err < 5e-5, f"rel err {err:.2e}"


def test_padded_frontend_matches_jax_phase_planes():
    """``fused_frontend_padded_reference`` against ``FS._fe_run``'s mod-3
    phase planes, re-interleaved, within 2e-5; the port's border and the
    TPU kernel's zero rows and masked tail are exactly zero."""
    _, _, fe_p, fe_s = _jax_params(0)
    bank = sinc_filterbank(70, 129, 16000).astype(np.float32)
    b, length = 2, 2400
    x = np.random.default_rng(2).normal(0, 1, (b, length)).astype(np.float32)
    t_z = (length - FS.KSIZE + 1) // 3
    u = 128
    v_z = -(-t_z // 3)                  # longest phase plane
    nt = -(-v_z // u)
    vtot = nt * u + FS.H9
    xq = np.transpose(np.pad(x, ((0, 0), (0, 9 * vtot - length)))
                      .reshape(b, vtot, 9), (2, 0, 1))
    xt = np.stack([xq[:, :, j * u:j * u + u + FS.H9] for j in range(nt)])
    inv = 1.0 / np.sqrt(fe_s["var"][0] + BN_EPS)
    sc = np.asarray([[fe_p["weight"][0] * inv,
                      fe_p["bias"][0] - fe_s["mean"][0] * fe_p["weight"][0]
                      * inv]], np.float32)
    planes = np.asarray(FS._fe_run(
        jnp.asarray(xt), jnp.asarray(FS.pack_w_frontend(bank)),
        jnp.asarray(sc), 2, u, 70, t_z))                  # (B, 96, nt * u)

    _, bn_p, bn_s = _port(*_jax_params(0))
    got = fs.fused_frontend_padded_reference(
        torch.from_numpy(x), torch.from_numpy(bank), bn_p, bn_s).numpy()
    assert got.shape == (b, 25, t_z + 2)
    assert np.all(got[:, 0] == 0) and np.all(got[:, 24] == 0)
    assert np.all(got[:, :, 0] == 0) and np.all(got[:, :, -1] == 0)
    # rows q * 32 + 1 + f of the planes hold z[:, f, 3 v + q]
    for q in range(3):
        n_q = -(-(t_z - q) // 3)
        plane = planes[:, q * 32 + 1:q * 32 + 24]
        np.testing.assert_allclose(got[:, 1:24, 1 + q:t_z + 1:3],
                                   plane[:, :, :n_q], atol=2e-5, rtol=0)
        assert np.all(plane[:, :, n_q:] == 0)
        assert np.all(planes[:, q * 32] == 0)
        assert np.all(planes[:, q * 32 + 24:(q + 1) * 32] == 0)


def _kernel_math(z, prm):
    """``csrc/fused_block0.cu``'s arithmetic from ``fold_block0``'s tensors,
    in plain PyTorch: conv1 with the folded taps and shift over the frame
    (no padding: the frame's border is conv1's), SELU, y1 zero-padded in
    time, conv2 + downsample, the pool, then the two biases."""
    c = prm.w1.shape[0]
    y1 = torch.selu(F.conv2d(z[:, None], prm.w1.reshape(c, 1, 2, 3))
                    + prm.shift1[:, None, None])           # (B, C, F+1, T)
    y2 = F.conv2d(F.pad(y1, (1, 1)),
                  prm.w2.permute(2, 0, 1).reshape(c, c, 2, 3))
    ds = F.conv2d(z[:, None, 1:-1], prm.wd.reshape(c, 1, 1, 3))
    return F.max_pool2d(y2 + ds, (1, 3)) + prm.bias[:, None, None]


@pytest.mark.parametrize("b,t_z", [(2, 29), (3, 5291)])
def test_folded_block0_weights_match_the_block(b, t_z):
    """The kernel's weight layout and arithmetic (folded bn2, zeroed y1
    halo, biases after the pool) reproduce the block's own chain."""
    block, _, _ = _port(*_jax_params(3))
    z = F.pad(torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (b, 23, t_z)).astype(np.float32)), (1, 1, 1, 1))
    with torch.inference_mode():
        ref = fs.fused_block0_reference(z, block)
        got = _kernel_math(z, fs.fold_block0(block))
    assert got.shape == ref.shape == (b, C, 23, t_z // 3)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor is no kernel launch; an unsupported device raises."""
    block, bn_p, bn_s = _port(*_jax_params(5))
    bank = torch.from_numpy(sinc_filterbank(70, 129, 16000))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (2, 1000)).astype(np.float32))
    # the kernel wrappers the two routers reach count the launches
    kernels = (fs.fused_frontend_padded_fma, fused_frontend_dot_padded,
               fs.fused_block0_fma, fs.fused_block0_mma, block0_pipe)
    before = [k.launches for k in kernels]
    with torch.inference_mode():
        z = fs.fused_frontend_padded(x, bank, bn_p, bn_s)
        out = fs.fused_block0(z, block)
        torch.testing.assert_close(
            z, fs.fused_frontend_padded_reference(x, bank, bn_p, bn_s),
            rtol=0, atol=0)
        torch.testing.assert_close(out, fs.fused_block0_reference(z, block),
                                   rtol=0, atol=0)
    assert [k.launches for k in kernels] == before
    with pytest.raises(ValueError, match="unsupported device"):
        fs.fused_frontend_padded(x.to("meta"), bank.to("meta"), bn_p, bn_s)
    with pytest.raises(ValueError, match="unsupported device"):
        fs.fused_block0(z.to("meta"), block)


SMALL_CONF = {
    "architecture": "AASIST",
    "first_conv": 128,
    "filts": [70, [1, 8], [8, 8], [8, 12], [12, 12]],
    "gat_dims": [12, 16],
    "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}


def test_block0_without_downsample_raises():
    model = build_model({**SMALL_CONF, "use_fused_stack": True,
                         "filts": [70, [1, 1], [1, 8], [8, 12], [12, 12]]})
    with pytest.raises(ValueError, match="downsample"):
        with torch.inference_mode():
            model(torch.zeros((1, 4000)))
    with pytest.raises(ValueError, match="downsample"):
        fs.fold_block0(ResidualBlock(8, 8, first=False))


def test_fused_stack_is_eval_only():
    model = build_model({**SMALL_CONF, "use_fused_stack": True})
    assert model.use_fused_stack
    model.train()
    with pytest.raises(RuntimeError, match="eval only"):
        model(torch.zeros((1, 4000)))


def test_cpu_scorer_same_scores_with_the_stack():
    model = build_model(SMALL_CONF)
    rng = np.random.default_rng(7)
    with torch.no_grad():        # BatchNorm off its identity init
        for bn in model.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                n = bn.running_mean.shape
                bn.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, n).astype(np.float32)))
                bn.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, n).astype(np.float32)))
    waves = [(rng.standard_normal(n) * 0.05).astype(np.float32)
             for n in (9000, 16000, 23000)]
    kw = dict(device="cpu", bf16=False, window=16000, batch_size=2)
    off = Scorer(model, **kw)
    on = Scorer(model, use_fused_stack=True, **kw)
    assert on.model.use_fused_stack and not off.model.use_fused_stack
    assert not model.use_fused_stack                  # caller's model kept
    np.testing.assert_allclose(on.score_waveforms(waves),
                               off.score_waveforms(waves), atol=1e-5, rtol=0)


def _stock(name, **changes):
    return {**load_config(f"{name}.conf").model_config, **changes}


NARROW_B0 = [70, [1, 16], [16, 16], [16, 24], [24, 24]]


@pytest.mark.parametrize("conf,bf16,device,stack,want", [
    (_stock("AASIST"), True, "cuda", None, "stack"),
    (_stock("AASIST-L"), True, "cuda", None, "stack"),
    (_stock("AASIST", filts=NARROW_B0), True, "cuda", None, "frontend"),
    (_stock("AASIST", filts=[70, [1, 1], [1, 32], [32, 24], [24, 24]]),
     True, "cuda", None, "frontend"),
    (_stock("AASIST2"), True, "cuda", None, "frontend"),
    (_stock("RawGATST_baseline"), True, "cuda", None, "frontend"),
    (_stock("AASIST"), False, "cuda", None, "stock"),
    (_stock("AASIST"), True, "cpu", None, "stock"),
    (_stock("AASIST"), True, "cuda", False, "frontend"),
    (_stock("AASIST2"), True, "cuda", True, ValueError),
], ids=["aasist", "aasist_l", "block0_1to16", "block0_no_downsample",
        "aasist2", "rawgat_st", "aasist_f32", "aasist_cpu",
        "aasist_stack_off", "aasist2_stack_on"])
def test_the_scorer_route_rule(conf, bf16, device, stack, want):
    """The Scorer's choice of kernels (``kernel_route``) for a device type,
    without a card: by default the frontend + block-0 pair in bf16 on CUDA
    exactly when the model has the stack path and its block 0 is 1 -> 32
    channels with a downsample; today's route otherwise (f32 and the CPU
    take no kernel by default); an explicit False keeps the frontend
    kernel; an explicit True on AASIST2 raises."""
    model = build_model(conf)
    if want is ValueError:
        with pytest.raises(ValueError, match="residual block 0 only"):
            kernel_route(model, bf16=bf16, device_type=device,
                         use_fused_stack=stack)
        return
    assert kernel_route(model, bf16=bf16, device_type=device,
                        use_fused_stack=stack) == want
    assert getattr(model, "use_fused_stack", False) == (want == "stack")
    if not hasattr(model, "has_fused_stack"):     # RawGAT-ST
        assert not hasattr(model, "use_fused_stack")
