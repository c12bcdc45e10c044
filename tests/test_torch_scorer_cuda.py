"""The Scorer's default route on a card: the frontend + block-0 kernel pair
against ``use_fused_stack=False`` (the frontend kernel, block 0 on stock
cuDNN ops).

Marked ``chip``: it skips without a CUDA card.  It imports no JAX, so it
runs on the card without the suite's ``conftest.py``::

    python3 -m pytest --noconftest tests/test_torch_scorer_cuda.py -m chip
"""

import numpy as np
import pytest
import torch

from aasist_tpu_torch.config import load_config
from aasist_tpu_torch.ops.block0_pipe import block0_pipe
from aasist_tpu_torch.ops.frontend_variants import (fused_frontend_dot_padded,
                                                    fused_frontend_dot_plain)
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.serving import Scorer

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
