"""The port's per-stage profile (``aasist_tpu_torch/tools/profile_stages``)
on the CPU.

On a narrow AASIST at 2 utterances of 16,000 samples, each cumulative cut of
each route (``frontend``, ``stack``, ``none``; on the CPU the kernels'
plain versions) against the JAX package's same chain in float32, composed
from ``aasist_tpu/models/layers.py`` as ``tools/profile_stages.py`` composes
it; the full cut equals the forward, and both the JAX forward.  The tool's
entry point on the CPU prints a line a cut and the throughput.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aasist_tpu import nn as jnn
from aasist_tpu.models import layers as JL
from aasist_tpu.registry import build_model as jax_build_model

from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.tools import profile_stages as ps
from aasist_tpu_torch.utils.pytree_io import flatten_tree, unflatten_tree
from aasist_tpu_torch.weights import jax_trees, load_jax_params

NARROW = {
    "architecture": "AASIST",
    "first_conv": 128,
    "filts": [70, [1, 8], [8, 8], [8, 12], [12, 12]],
    "gat_dims": [12, 16],
    "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}
B, LENGTH = 2, 16000
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module (restored after): the suite runs six
    workers on eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """(the port's model, x, the JAX chain's outputs after the frontend and
    each block, the JAX forward's logits), the same seeded weights on both
    sides through ``load_jax_params``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        params, state = (unflatten_tree(flatten_tree(t))   # JAX's lists
                         for t in jax_trees(build_model(NARROW)))
    rng = np.random.default_rng(3)
    for bs in state["encoder"] + [state["first_bn"]]:
        for bn in (bs.values() if "mean" not in bs else [bs]):
            bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(
                np.float32)
    x = (rng.standard_normal((B, LENGTH)) * 0.1).astype(np.float32)

    jm = jax_build_model(NARROW)

    def chain(params, state, x):
        """tools/profile_stages.py:68-84's chain, in float32: the outputs
        after the frontend and each block, and the forward's logits."""
        h = JL.sinc_frontend(jnp.asarray(jm.filterbank, jnp.float32), x)
        h = jnn.max_pool(jnp.abs(h)[:, None], (3, 3))
        h, _ = jnn.batch_norm(params["first_bn"], state["first_bn"], h,
                              axis=1, train=False)
        outs = [jax.nn.selu(h)]
        for i in range(6):
            h, _ = JL.residual_block_apply(params["encoder"][i],
                                           state["encoder"][i], outs[-1],
                                           first=(i == 0), train=False)
            outs.append(h)
        (_, logits), _ = jm.apply(params, state, x, train=False)
        return outs, logits

    outs, logits = jax.jit(chain)(params, state, jnp.asarray(x))
    model = load_jax_params(build_model(NARROW), params, state)
    return (model, torch.from_numpy(x), [np.asarray(o) for o in outs],
            np.asarray(logits))


@pytest.mark.parametrize("path", ps.PATHS)
def test_cuts_match_the_jax_chain(case, path):
    model, x, want, want_logits = case
    ps.set_path(model, path)
    with torch.inference_mode():
        for i, name in enumerate(ps.NAMES):
            got = ps.cut(model, i)(x)
            if path == "stack" and i == 0:
                # the padded store: the frontend inside a zero border
                assert got.shape == (B, want[0].shape[2] + 2,
                                     want[0].shape[3] + 2)
                border = got.clone()
                border[:, 1:-1, 1:-1] = 0
                assert not border.any()
                got = got[:, None, 1:-1, 1:-1]
            got = got.numpy()
            print(f"{path} {name}: max|d| {np.abs(got - want[i]).max():.3e}")
            np.testing.assert_allclose(got, want[i], **TOL, err_msg=name)
        logits = model(x)[1]
    rows, full = ps.profile(model, x, path, iters=1)
    assert [r.name for r in rows] == list(ps.NAMES) + ["full"]
    assert torch.equal(full, logits)
    np.testing.assert_allclose(full.numpy(), want_logits, **TOL)
    # each row's value is its cut's sum
    sums = [float(np.sum(w, dtype=np.float64)) for w in want]
    np.testing.assert_allclose([r.value for r in rows[:-1]], sums,
                               rtol=1e-4)
    assert rows[-1].value == pytest.approx(float(logits.sum()), rel=1e-6)
    assert (model.use_fused_frontend, model.use_fused_stack) == (
        path == "frontend", path == "stack")


def test_report_lines():
    rows = [ps.Cut(n, 2.0 * (i + 1), 0.0)
            for i, n in enumerate(list(ps.NAMES) + ["full"])]
    lines = ps.report(rows, 128, "card")
    assert len(lines) == 9 and lines[-1].startswith("throughput")
    assert "graph stack" in lines[-2] and "+2.000 ms" in lines[-2]
    assert "8000.0 utt/s" in lines[-1] and all("[card]" in ln
                                               for ln in lines)


def test_entry_point_on_the_cpu(monkeypatch):
    """``main`` at batch 1, one timed call: a line a cut and the
    throughput.  The pretrained model's full-width forward is costly on
    the CPU, so the model is the narrow one and the window 16,000."""
    monkeypatch.setattr(ps, "CONF", NARROW)
    monkeypatch.setattr(ps, "load_npz", lambda model, path: model)
    monkeypatch.setattr(ps, "WINDOW", LENGTH)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ps.main(["1", "--iters", "1", "--device", "cpu", "--dtype",
                        "float32", "--path", "stack"]) == 0
    lines = out.getvalue().splitlines()
    print("\n".join(lines))
    assert len(lines) == 10 and "path stack, batch 1" in lines[0]
    assert lines[-1].startswith("throughput") and "cpu" in lines[-1]
