"""SSL-AASIST in the port (``models/ssl_aasist.py``) on the CPU: against the
plain reference ``tests/ssl_aasist_reference.py`` on seeded random weights
at a small size, the published config's shapes from a meta-device run (no
full-size forward on the CPU), the Scorer on the stock route, the residual
block with and without its pool, the attention counter and the spans."""

import contextlib
import math

import numpy as np
import pytest
import torch

from aasist_tpu_torch import serving
from aasist_tpu_torch.config import load_config
from aasist_tpu_torch.data.dataset import pad_to_fixed
from aasist_tpu_torch.models import ssl_aasist
from aasist_tpu_torch.models.layers import ResidualBlock
from aasist_tpu_torch.ops.fused_stack import takes_block0
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.utils import profiling

import ssl_aasist_reference as ref
from test_torch_spans import _spans
from test_torch_train_models import one_torch_thread  # noqa: F401

# conv_dim 32, hidden 64, 2 layers, 4 heads, FFN 128, a position kernel of
# 16 taps in 4 groups; the back end at its published widths (cheap)
SMALL = {
    "architecture": "SSL_AASIST",
    "conv_feature_layers": [[32, 10, 5]] + [[32, 3, 2]] * 4
    + [[32, 2, 2]] * 2,
    "encoder_embed_dim": 64, "encoder_layers": 2,
    "encoder_attention_heads": 4, "encoder_ffn_embed_dim": 128,
    "conv_pos": 16, "conv_pos_groups": 4,
    "filts": [128, [1, 32], [32, 32], [32, 64], [64, 64]],
    "gat_dims": [64, 32], "pool_ratios": [0.5, 0.5, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0]}
LENGTH = 8000           # 24 frames: (8, 8) after the (3, 3) pool
STAGES = (["model.ssl.features", "model.ssl.encoder", "model.head"]
          + [f"model.block{i}" for i in range(6)] + ["model.graph"])


class _Reads(dict):
    """A parameter dict that records the names read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _seeded(model, seed):
    """``model`` filled with seeded weights: fan-in scaled matrices and
    kernels, small biases, norms near the identity, BatchNorm statistics
    off 0 / 1, the free nodes standard normal; returns the dict too."""
    g = torch.Generator().manual_seed(seed)
    P = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        z = torch.randn(t.shape, generator=g)
        if name.endswith("running_var"):
            P[name] = 0.5 + torch.rand(t.shape, generator=g)
        elif name.endswith("running_mean") or name.endswith(".bias"):
            P[name] = 0.1 * z
        elif t.dim() == 1:                      # LayerNorm / BatchNorm
            P[name] = 1.0 + 0.1 * z
        elif name in ("pos_S", "master1", "master2"):
            P[name] = z
        else:
            P[name] = z / math.sqrt(math.prod(t.shape[1:]))
    model.load_state_dict(P, strict=False)
    return P


@pytest.fixture(scope="module")
def small():
    model = build_model(SMALL)
    P = _seeded(model, 2**31 + 21)
    x = torch.from_numpy((np.random.default_rng(3).standard_normal(
        (3, LENGTH)) * 0.1).astype(np.float32))
    return model, P, x


def test_the_port_matches_the_plain_reference(small):
    model, P, x = small
    reads = _Reads(P)
    with torch.inference_mode():
        hidden, logits = model(x)
        want_hidden, want_logits = ref.forward(reads, x, SMALL)
    # both in float32: the port's fused LayerNorm, GELU, SDPA and BatchNorm
    # against the written-out formulas differ by round-off of ~1e-6 a
    # layer, which the 26 layers and graph pooling's scaling grow to
    # ~1e-5 on logits of magnitude ~5; 1e-4 leaves room for that and is
    # far under any dropped or misplaced term (~1e-1)
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(hidden.numpy(), want_hidden.numpy(),
                               atol=1e-3, rtol=0)
    # the reference reads every tensor the model holds but the residual
    # blocks' bn1, which never reaches the output (the source's quirk)
    assert set(P) - reads.read == {
        f"encoder.{i}.bn1.{k}" for i in range(1, 6)
        for k in ("weight", "bias", "running_mean", "running_var")}
    assert reads.read <= set(P)


def test_published_shapes_on_the_meta_device():
    """The published config (the packaged SSL_AASIST.conf) at the 64,600-sample
    window, shapes only: 201 frames of 1024, a (42, 67) back-end map, 24
    attention calls, 315,884,810 parameters."""
    mc = load_config("SSL_AASIST").model_config
    seen = {}

    def pre(module, args):
        seen["map_in"] = tuple(args[0].shape)

    def post(module, args, out):
        seen["map_out"] = tuple(out.shape)

    with torch.device("meta"):
        model = build_model(mc)
        model.encoder[0].register_forward_pre_hook(pre)
        model.encoder[5].register_forward_hook(post)
        x = torch.empty(2, 64600)
        feats = model.ssl.features(x)
        hidden, logits = model(x)
    assert tuple(feats.shape) == (2, 201, 1024)
    assert seen == {"map_in": (2, 1, 42, 67), "map_out": (2, 64, 42, 67)}
    assert tuple(hidden.shape) == (2, 160) and tuple(logits.shape) == (2, 2)
    assert model.ssl.attention_calls == 24
    assert sum(p.numel() for p in model.parameters()) == 315_884_810


def test_the_attention_calls_are_counted(small):
    model, _, x = small
    with torch.inference_mode():
        model(x[:1])
        model(x)
    assert model.ssl.attention_calls == SMALL["encoder_layers"]
    assert model.ssl.sdpa_backend in {b.name for b in ssl_aasist.FUSED_SDPA
                                      } | {"MATH"}


def test_the_scorer_takes_the_stock_route(small):
    model, _, x = small
    assert serving.kernel_route(model, bf16=True, device_type="cuda") == \
        "stock"
    with pytest.raises(ValueError, match="no fused frontend path"):
        serving.kernel_route(model, bf16=True, device_type="cuda",
                             use_fused_frontend=True)
    scorer = serving.Scorer(model, device="cpu", bf16=False, batch_size=2,
                            window=LENGTH)
    assert scorer.batch_size == 2 and not scorer.model.training
    rng = np.random.default_rng(4)
    waves = [(rng.standard_normal(n) * 0.1).astype(np.float32)
             for n in (5000, LENGTH, 9000)]
    got = scorer.score_waveforms(waves)
    rows = torch.from_numpy(np.stack([pad_to_fixed(w, LENGTH)
                                      for w in waves]))
    with torch.inference_mode():
        want = model(rows)[1][:, 1].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert serving.SERVING_BATCH_DEFAULTS["SSL_AASIST"] == 128


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "no_pool"])
def test_residual_block_with_and_without_its_pool(pool):
    torch.manual_seed(0)
    block = ResidualBlock(1, 32, first=True, pool=pool).eval()
    x = torch.randn(2, 1, 5, 12)
    with torch.inference_mode():
        y = block(x)
        block.pool = not pool
        other = block(x)
    pooled, unpooled = (y, other) if pool else (other, y)
    assert tuple(unpooled.shape) == (2, 32, 5, 12)
    assert tuple(pooled.shape) == (2, 32, 5, 4)
    torch.testing.assert_close(
        torch.nn.functional.max_pool2d(unpooled, (1, 3)), pooled)
    block.pool = pool
    # the block-0 kernels compute the pooled block only
    assert takes_block0(block) == pool


def test_train_mode_raises():
    model = build_model(SMALL)
    with pytest.raises(RuntimeError, match="eval only"):
        model.train()
    assert not model.eval().training


def test_forward_records_its_stages(small, tmp_path):
    model, _, x = small
    with profiling.trace(tmp_path / "t") as prof, torch.inference_mode():
        model(x)
    assert [s[0] for s in _spans(prof)] == STAGES


def test_encoder_span_carries_frames_and_backend(small, monkeypatch):
    model, _, x = small
    calls = []

    def annotate(name, args=None):
        calls.append((name, args))
        return contextlib.nullcontext()

    monkeypatch.setattr(ssl_aasist, "annotate", annotate)
    with torch.inference_mode():
        model(x)
    assert ("model.ssl.encoder",
            f"frames=24 sdpa={model.ssl.sdpa_backend}") in calls
    assert [c[0] for c in calls] == ["model.ssl.features",
                                     "model.ssl.encoder", "model.head",
                                     "model.graph"]


def test_scorer_from_config_loads_saved_weights(small, tmp_path):
    """A config naming the architecture and a ``.npz`` of the model's
    weights (``weights.save_npz``) builds the same scorer: strict both
    ways, so every tensor of the flat scheme round-trips."""
    import json

    from aasist_tpu_torch.weights import save_npz
    model, _, x = small
    save_npz(model, tmp_path / "w.npz")
    conf = {"model_path": str(tmp_path / "w.npz"), "model_config": SMALL}
    (tmp_path / "small.conf").write_text(json.dumps(conf))
    scorer = serving.Scorer.from_config(tmp_path / "small.conf",
                                        device="cpu", bf16=False,
                                        batch_size=3, window=LENGTH)
    got = scorer.score_waveforms(list(x.numpy()))
    with torch.inference_mode():
        want = model(x)[1][:, 1].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
