"""The Scorer's default route on a card: the frontend + block-0 kernel pair
against ``use_fused_stack=False`` (the frontend kernel, block 0 on stock
cuDNN ops); a small request at its 16-row bucket against the same rows in
a full batch; SSL-AASIST's stock route, its attention on a fused SDPA
backend, and that backend as reported against the traced kernels.

Marked ``chip``: it skips without a CUDA card.  It imports no JAX, so it
runs on the card without the suite's ``conftest.py``::

    python3 -m pytest --noconftest tests/test_torch_scorer_cuda.py -m chip
"""

import json

import numpy as np
import pytest
import torch

from aasist_tpu_torch.config import load_config
from aasist_tpu_torch.ops.block0_pipe import block0_pipe
from aasist_tpu_torch.ops.frontend_variants import (fused_frontend_dot_padded,
                                                    fused_frontend_dot_plain)
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.serving import Scorer
from aasist_tpu_torch.utils import profiling

BATCH = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.mark.chip
def test_default_scorer_runs_the_stack_and_matches_the_frontend_route(card):
    """AASIST with BatchNorm statistics moved off their init values: the
    default bf16 Scorer takes the kernel pair, one ``block0_pipe`` and one
    padded frontend launch a batch and no plain frontend launch, and its
    scores are those of ``use_fused_stack=False`` within 5 % of
    max(|score|, 2), the bf16 gate of ``chip_smoke.py``'s eval phase."""
    torch.manual_seed(0)
    model = build_model(load_config("AASIST.conf").model_config)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                n = bn.running_mean.shape
                bn.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, n).astype(np.float32)))
                bn.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, n).astype(np.float32)))
    waves = [(rng.standard_normal(n) * 0.1).astype(np.float32)
             for n in rng.integers(16000, 96001, 3 * BATCH - 1)]
    n_batches = -(-len(waves) // BATCH)

    stack = Scorer(model, batch_size=BATCH, device=card)
    frontend = Scorer(model, batch_size=BATCH, device=card,
                      use_fused_stack=False)
    assert stack.model.use_fused_stack and not frontend.model.use_fused_stack
    kernels = (block0_pipe, fused_frontend_dot_padded,
               fused_frontend_dot_plain)
    before = [k.launches for k in kernels]
    got = np.asarray(stack.score_waveforms(waves))
    after = [k.launches for k in kernels]
    want = np.asarray(frontend.score_waveforms(waves))
    assert [a - b for a, b in zip(after, before)] == [n_batches,
                                                      n_batches, 0]
    assert got.shape == want.shape == (len(waves),)
    assert np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 2.0)
    assert rel.max() <= 0.05, (got, want)


@pytest.mark.chip
def test_a_small_request_runs_one_16_row_forward(card):
    """The default bf16 Scorer (batch 128, the kernel pair) runs a request
    of 1, 5 or 16 rows as one 16-row forward with one ``block0_pipe``
    launch, and scores each row as the same row scored inside a full
    128-row call, within 5 % of max(|score|, 2) (the gate above)."""
    torch.manual_seed(0)
    model = build_model(load_config("AASIST.conf").model_config)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                n = bn.running_mean.shape
                bn.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, n).astype(np.float32)))
                bn.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, n).astype(np.float32)))
    waves = [(rng.standard_normal(n) * 0.1).astype(np.float32)
             for n in rng.integers(16000, 96001, 128)]
    scorer = Scorer(model, device=card)
    assert scorer.model.use_fused_stack and scorer.batch_size == 128
    full = np.asarray(scorer.score_waveforms(waves))
    assert scorer.counters["by_rows"][128] == 1
    for n in (1, 5, 16):
        counted, launched = scorer.counters, block0_pipe.launches
        got = np.asarray(scorer.score_waveforms(waves[:n]))
        now = scorer.counters
        assert block0_pipe.launches - launched == 1
        assert now["batches"] - counted["batches"] == 1
        assert now["rows_run"] - counted["rows_run"] == 16
        assert now["by_rows"][16] - counted["by_rows"][16] == 1
        assert got.shape == (n,) and np.isfinite(got).all()
        rel = np.abs(got - full[:n]) / np.maximum(np.abs(full[:n]), 2.0)
        assert rel.max() <= 0.05, (n, got, full[:n])


@pytest.fixture(scope="module")
def ssl_model():
    """SSL-AASIST at its published widths, its own random init."""
    torch.manual_seed(0)
    return build_model(load_config("SSL_AASIST.conf").model_config)


@pytest.mark.chip
def test_ssl_aasist_scorer_attends_on_a_fused_backend(card, ssl_model):
    """SSL-AASIST: the default bf16 Scorer takes the stock route, runs 24
    attention calls a forward on a fused SDPA backend, never the math
    path, and scores as the float32 Scorer with TF32 off does, within 5 %
    of max(|score|, 2) (the gate above)."""
    from aasist_tpu_torch.cli import full_f32
    model = ssl_model
    rng = np.random.default_rng(8)
    waves = [(rng.standard_normal(n) * 0.1).astype(np.float32)
             for n in rng.integers(16000, 96001, 2 * BATCH - 1)]
    bf16 = Scorer(model, batch_size=BATCH, device=card)
    got = np.asarray(bf16.score_waveforms(waves))
    ssl = bf16.model.ssl
    assert ssl.attention_calls == 24
    assert ssl.sdpa_backend in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                                "CUDNN_ATTENTION"), ssl.sdpa_backend
    f32 = Scorer(model, batch_size=BATCH, device=card, bf16=False)
    with full_f32():
        want = np.asarray(f32.score_waveforms(waves))
    assert f32.model.ssl.sdpa_backend != "MATH"
    assert np.isfinite(got).all() and got.shape == want.shape
    rel = np.abs(got - want) / np.maximum(np.abs(want), 2.0)
    assert rel.max() <= 0.05, (got, want)


# the backend whose kernels a traced attention kernel's name shows, by the
# first of these its name holds (cuDNN's names hold "flash" too)
_BACKEND_BY_NAME = (("cudnn", "CUDNN_ATTENTION"),
                    ("fmha", "EFFICIENT_ATTENTION"),
                    ("efficient", "EFFICIENT_ATTENTION"),
                    ("flash", "FLASH_ATTENTION"))


@pytest.mark.chip
def test_ssl_aasist_reported_backend_is_the_traced_kernels(card, ssl_model,
                                                           tmp_path):
    """``model.ssl.sdpa_backend`` comes from the private
    ``torch._fused_sdp_choice``: a traced bf16 forward's attention kernels
    (the names ``attention_roofline.score`` reads) are all of the backend
    it names, a whole number of them for each of the 24 calls."""
    scorer = Scorer(ssl_model, batch_size=BATCH, device=card)
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.standard_normal((BATCH, scorer.window))
                          * 0.1).astype(np.float32)).to(card)
    with torch.inference_mode():
        scorer.model(x)
        with profiling.trace(tmp_path):
            scorer.model(x)
    reported = scorer.model.ssl.sdpa_backend
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"
             and any(k in e["name"].lower()
                     for k in ("flash", "fmha", "sdpa", "attention"))]
    shown = {next((b for key, b in _BACKEND_BY_NAME if key in n.lower()),
                  n) for n in names}
    assert shown == {reported}, (reported, sorted(set(names)))
    assert names and len(names) % 24 == 0, (len(names), sorted(set(names)))
