"""The zoo's layers in the PyTorch port against their JAX counterparts on
the CPU: SE, the Res2Net block (AASIST2's encoder), speaker conditioning
and graph pooling with a minimum node count (RawGAT-ST).

Inputs are made with numpy from a seed; the JAX layer's initialised
weights (BatchNorm statistics and affine moved off their identity values)
are carried into the port's module by ``load_jax_params``.  f32, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

from aasist_tpu.models import layers as JL
from aasist_tpu.nn import RngStream

from aasist_tpu_torch.models import layers as TL
from aasist_tpu_torch.weights import load_jax_params

ATOL = 1e-5


def perturb_bn(params, state, rng):
    """(params, state) as float32 numpy trees, every BatchNorm's statistics
    and affine moved off 0 / 1 (the other leaves are random from init)."""
    to_np = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), t)
    params, state = to_np(params), to_np(state)

    def walk(p, s):
        if isinstance(s, dict) and set(s) == {"mean", "var"}:
            n = s["mean"].shape
            s["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
            s["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            p["weight"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            p["bias"] = rng.normal(0, 0.2, n).astype(np.float32)
            return
        for k, sub in (s.items() if isinstance(s, dict) else enumerate(s)):
            walk(p[k], sub)

    walk(params, state)
    return params, state


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("channels", [32, 64])
def test_se(channels):
    p = JL.se_init(jax.random.PRNGKey(1), channels)
    x = _x((2, channels, 5, 9), 2)
    mod = load_jax_params(TL.SE(channels), jax.tree_util.tree_map(
        np.asarray, p), {})
    with torch.inference_mode():
        _close(mod(torch.from_numpy(x)), JL.se_apply(p, x))


@pytest.mark.parametrize("in_ch,out_ch,first", [
    (1, 32, True),      # width and scale clamp to 1: one split
    (32, 32, False),    # thirteen splits of 2 and one of 6, carry at 8
    (32, 64, False),    # the downsample conv on the identity
])
def test_res2net_block(in_ch, out_ch, first):
    p, s = JL.res2net_block_init(jax.random.PRNGKey(3), in_ch, out_ch,
                                 first=first, width=14, scale=8)
    p, s = perturb_bn(p, s, np.random.default_rng(4))
    x = _x((2, in_ch, 6, 30), 5)
    ref, _ = JL.res2net_block_apply(p, s, x, first=first, width=14, scale=8,
                                    train=False)
    block = TL.Res2NetBlock(in_ch, out_ch, first=first, width=14,
                            scale=8).eval()
    if in_ch == 32:
        assert block.sizes == [2] * 13 + [6] and block.scale == 8
    else:
        assert block.sizes == [1]
    load_jax_params(block, p, s)
    with torch.inference_mode():
        _close(block(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("level,attention,feat_shape", [
    ("frame", True, (2, 7, 16)),
    ("frame", False, (2, 7, 16)),
    ("utterance", True, (2, 7, 16)),     # averaged over the nodes
    ("utterance", False, (2, 16)),
])
def test_speaker_conditioning(level, attention, feat_shape):
    p = jax.tree_util.tree_map(np.asarray, JL.speaker_cond_init(
        jax.random.PRNGKey(6), 24, 16, use_attention=attention))
    feats, spk = _x(feat_shape, 7), _x((2, 24), 8)
    ref = JL.speaker_cond_apply(p, feats, spk, level=level,
                                use_attention=attention)
    mod = load_jax_params(TL.SpeakerConditioning(
        24, 16, use_attention=attention, level=level), p, {})
    with torch.inference_mode():
        _close(mod(torch.from_numpy(feats), torch.from_numpy(spk)), ref)


@pytest.mark.parametrize("n,k,min_nodes,kept", [
    (3, 0.5, 2, 2),       # int(1.5) = 1 node, raised to RawGAT-ST's 2
    (23, 0.64, 2, 14),    # RawGAT-ST's spectral pool
    (3, 0.3, 1, 1),       # AASIST's minimum
])
def test_graph_pool_min_nodes(n, k, min_nodes, kept):
    p = jax.tree_util.tree_map(np.asarray, JL.graph_pool_init(
        jax.random.PRNGKey(9), 16))
    h = _x((2, n, 16), 10)
    ref = JL.graph_pool_apply(p, h, k=k, min_nodes=min_nodes, dropout_p=0.3,
                              train=False, rngs=RngStream(None))
    mod = load_jax_params(TL.GraphPool(16, k, min_nodes=min_nodes).eval(),
                          p, {})
    with torch.inference_mode():
        got = mod(torch.from_numpy(h))
    assert got.shape == (2, kept, 16) == ref.shape
    _close(got, ref)
