"""Each layer of the PyTorch port against its JAX counterpart on the CPU.

Inputs are made with numpy from a seed; the JAX layer's initialised
weights (with BatchNorm statistics and affine moved off their identity
values) are carried into the port's module by ``load_jax_params``.  f32,
atol 1e-5 unless stated.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aasist_tpu import nn as jnn
from aasist_tpu.models import layers as JL
from aasist_tpu.ops.fused_frontend import fused_frontend as jax_fused_frontend
from aasist_tpu.nn import RngStream

from aasist_tpu_torch import nn as tnn
from aasist_tpu_torch.models import layers as TL
from aasist_tpu_torch.ops.frontend_variants import fused_frontend_dot_plain
from aasist_tpu_torch.ops.fused_frontend import (fused_frontend,
                                                 fused_frontend_fma,
                                                 fused_frontend_reference)
from aasist_tpu_torch.weights import load_jax_params

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _perturb(params, state, rng):
    """Move BatchNorm affine and statistics off 1 / 0 so eval BN is tested
    (every other leaf is already random from init)."""
    def walk(p, s):
        if isinstance(p, dict):
            for k in p:
                if k.startswith("bn") and "weight" in p[k]:
                    n = p[k]["weight"].shape
                    p[k]["weight"] = rng.uniform(0.5, 1.5, n).astype(
                        np.float32)
                    p[k]["bias"] = rng.normal(0, 0.2, n).astype(np.float32)
                    if s is not None and k in s:
                        s[k]["mean"] = rng.normal(0, 0.2, n).astype(
                            np.float32)
                        s[k]["var"] = rng.uniform(0.5, 1.5, n).astype(
                            np.float32)
                else:
                    walk(p[k], s.get(k) if isinstance(s, dict) else None)
        elif isinstance(p, list):
            for i, sub in enumerate(p):
                walk(sub, s[i] if s is not None else None)
    params, state = _np_tree(params), _np_tree(state)
    walk(params, state)
    return params, state


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, ref, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


# ------------------------------------------------------------ primitives
@pytest.mark.parametrize("channels,ksize", [(70, 128), (20, 64), (8, 129)])
def test_sinc_filterbank_exact(channels, ksize):
    ref = JL.sinc_filterbank(channels, ksize)
    got = TL.sinc_filterbank(channels, ksize)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,axis", [((2, 3, 5, 7), 1), ((2, 6, 5), -1)])
def test_eval_batch_norm(shape, axis):
    rng = np.random.default_rng(0)
    c = shape[axis]
    x = rng.standard_normal(shape).astype(np.float32)
    p = {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 0.2, c).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    ref, _ = jnn.batch_norm(p, s, jnp.asarray(x), axis=axis % len(shape),
                            train=False)
    bn = torch.nn.BatchNorm1d(c).eval()
    load_jax_params(bn, p, s)
    _close(tnn.batch_norm(bn, _t(x), axis=axis), ref)


@pytest.mark.parametrize("window,shape", [((3, 3), (2, 1, 70, 101)),
                                          ((1, 3), (2, 4, 5, 29))])
def test_max_pool_floor(window, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = jnn.max_pool(jnp.asarray(x), window)
    got = tnn.max_pool(_t(x), window)
    assert tuple(got.shape) == ref.shape
    _close(got, ref, atol=0)


def test_selu():
    x = np.linspace(-8, 8, 1001).astype(np.float32)
    _close(tnn.selu(_t(x)), jax.nn.selu(jnp.asarray(x)), atol=1e-6)


# ------------------------------------------------------------ graph layers
def test_graph_attention():
    rng = np.random.default_rng(2)
    p, s = JL.gat_init(jax.random.PRNGKey(0), 12, 16)
    p, s = _perturb(p, s, rng)
    x = rng.standard_normal((3, 9, 12)).astype(np.float32)
    ref, _ = JL.gat_apply(p, s, jnp.asarray(x), temperature=2.0,
                          train=False, rngs=RngStream(None))
    mod = load_jax_params(TL.GraphAttention(12, 16, 2.0).eval(), p, s)
    with torch.no_grad():
        _close(mod(_t(x)), ref)


@pytest.mark.parametrize("with_master", [False, True])
def test_htrg_graph_attention(with_master):
    rng = np.random.default_rng(3)
    p, s = JL.htrg_gat_init(jax.random.PRNGKey(1), 12, 16)
    p, s = _perturb(p, s, rng)
    x1 = rng.standard_normal((2, 7, 12)).astype(np.float32)
    x2 = rng.standard_normal((2, 5, 12)).astype(np.float32)
    m = (rng.standard_normal((1, 1, 12)).astype(np.float32)
         if with_master else None)
    r1, r2, rm, _ = JL.htrg_gat_apply(
        p, s, jnp.asarray(x1), jnp.asarray(x2),
        None if m is None else jnp.asarray(m), temperature=100.0,
        train=False, rngs=RngStream(None))
    mod = load_jax_params(TL.HtrgGraphAttention(12, 16, 100.0).eval(), p,
                          s)
    with torch.no_grad():
        g1, g2, gm = mod(_t(x1), _t(x2), None if m is None else _t(m))
    _close(g1, r1)
    _close(g2, r2)
    _close(gm, rm)


@pytest.mark.parametrize("n,k", [(23, 0.5), (29, 0.7), (11, 0.5), (3, 0.1)])
def test_graph_pool_keeps_order(n, k):
    rng = np.random.default_rng(4)
    p = _np_tree(JL.graph_pool_init(jax.random.PRNGKey(2), 8))
    h = rng.standard_normal((3, n, 8)).astype(np.float32)
    ref = JL.graph_pool_apply(p, jnp.asarray(h), k=k, min_nodes=1,
                              dropout_p=0.3, train=False,
                              rngs=RngStream(None))
    mod = load_jax_params(TL.GraphPool(8, k).eval(), p, {})
    with torch.no_grad():
        got = mod(_t(h))
        scores = torch.sigmoid(mod.proj(_t(h)))[..., 0]
    assert tuple(got.shape) == ref.shape == (3, max(int(n * k), 1), 8)
    # same kept nodes in the same (descending-score) order
    _, jidx = jax.lax.top_k(jnp.asarray(scores.numpy()), ref.shape[1])
    tidx = torch.topk(scores, ref.shape[1], dim=1, sorted=True).indices
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(got, ref)


@pytest.mark.parametrize("cin,cout,first", [(1, 8, True), (8, 8, True),
                                            (8, 12, False), (12, 12, False)])
def test_residual_block(cin, cout, first):
    rng = np.random.default_rng(5)
    p, s = JL.residual_block_init(jax.random.PRNGKey(3), cin, cout, first)
    p, s = _perturb(p, s, rng)
    x = rng.standard_normal((2, cin, 7, 40)).astype(np.float32)
    ref, _ = JL.residual_block_apply(p, s, jnp.asarray(x), first=first,
                                     train=False)
    mod = TL.ResidualBlock(cin, cout, first).eval()
    assert hasattr(mod, "bn1") == (not first)
    assert (mod.conv_downsample is None) == (cin == cout)
    load_jax_params(mod, p, s)
    with torch.no_grad():
        _close(mod(_t(x)), ref)


# ------------------------------------------------------------ frontend
def _bn():
    bn_p = {"weight": np.asarray([1.3], np.float32),
            "bias": np.asarray([-0.2], np.float32)}
    bn_s = {"mean": np.asarray([0.13], np.float32),
            "var": np.asarray([1.7], np.float32)}
    return bn_p, bn_s


@pytest.mark.parametrize("b,length,masked", [
    (1, 2000, False), (2, 4000, False), (3, 6400, False), (2, 4000, True)])
def test_fused_frontend_reference_matches_jax_kernel(b, length, masked):
    """The plain version against the Pallas kernel run in interpret mode,
    at the kernel's own gate (atol 1e-4)."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((b, length)) * 0.1).astype(np.float32)
    bank = JL.sinc_filterbank(70, 128)
    if masked:
        bank[10:20] = 0.0
    bn_p, bn_s = _bn()
    ref = jax_fused_frontend(jnp.asarray(x), jnp.asarray(bank), bn_p, bn_s)
    tbn_p = {k: _t(v) for k, v in bn_p.items()}
    tbn_s = {k: _t(v) for k, v in bn_s.items()}
    got = fused_frontend_reference(_t(x), _t(bank), tbn_p, tbn_s)
    assert tuple(got.shape) == ref.shape == (b, 1, 23, (length - 128) // 3)
    _close(got, ref, atol=1e-4)


def test_fused_frontend_cpu_tensor_uses_plain_version():
    """A CPU tensor takes the plain version and is no kernel launch."""
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((2, 1000)) * 0.1)
    bank = _t(TL.sinc_filterbank(70, 128))
    bn_p, bn_s = _bn()
    bn_p = {k: _t(v) for k, v in bn_p.items()}
    bn_s = {k: _t(v) for k, v in bn_s.items()}
    kernels = (fused_frontend_fma, fused_frontend_dot_plain)
    before = [k.launches for k in kernels]
    got = fused_frontend(x, bank, bn_p, bn_s)
    assert [k.launches for k in kernels] == before
    torch.testing.assert_close(
        got, fused_frontend_reference(x, bank, bn_p, bn_s), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_frontend(x.to("meta"), bank.to("meta"), bn_p, bn_s)
