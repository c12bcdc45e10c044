"""The plain version of the chained-dot kernel (``aasist_tpu_torch/ops/
mma_shapes``) against ``tools/probe_mxu_shapes.py``, on the CPU.

The probe calls ``pl.pallas_call`` without ``interpret``; the tests patch it
to interpret mode, with nothing in ``tools/`` changed.  Its kernel fixes eps
at 1e-30, where the bf16 add leaves a unchanged at inputs of order one, so
its ``run`` is held against ``mma_chain_reference`` with w scaled until the
update shows; a ``jax.numpy`` statement of ``_kernel``'s loop, written
here, is a second witness at the visible eps of the card's check
(``tools/_common.py:mma_eps``).  Both under the card's gates
(``mma_readings``).  w and a come from numpy seeds, rounded to bf16 once
and handed to both sides as the same values.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from aasist_tpu_torch.ops import mma_shapes as ms
from aasist_tpu_torch.tools import _common

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools"))
import probe_mxu_shapes as PM  # noqa: E402


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


def _inputs(seed, k, m, n_cols=ms.N_COLS):
    """(w, a) as torch bf16 tensors and as the same jax bf16 arrays."""
    r = np.random.default_rng(seed)
    w = torch.from_numpy(r.normal(0, 1, (k, m)).astype(np.float32))
    a = torch.from_numpy(r.normal(0, 1, (k, n_cols)).astype(np.float32))
    w, a = w.bfloat16(), a.bfloat16()
    return (w, a, jnp.asarray(w.float().numpy(), jnp.bfloat16),
            jnp.asarray(a.float().numpy(), jnp.bfloat16))


def _jnp_chain(w, a, n, eps):
    """``tools/probe_mxu_shapes.py:_kernel``'s loop in jax.numpy, with eps
    a parameter: the whole operand after n dots."""
    def body(_, a_scr):
        y = lax.dot_general(w, a_scr, (((0,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
        s = jnp.sum(y * y, axis=0, keepdims=True) * eps
        return a_scr.at[0:1, :].set(a_scr[0:1, :] + s.astype(a_scr.dtype))
    return lax.fori_loop(0, n, body, a)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", ["k12_m192", "k132_m210", "k192_m32"])
def test_reference_matches_probe_run(interpret_pallas, name, n):
    """At the probe's own eps of 1e-30 the update shows when w is scaled
    instead: w ~ N(0, 1) sqrt(4e30 / (K M)) gives 1e-30 sum_m y^2 ~ 4 a
    dot, with y^2 far inside the f32 range.  The probe's (8, 128) output
    is held to the plain version under the card's gates (rows 1..7
    exact)."""
    k, m = ms.SHAPES[name]
    w, a, _, aj = _inputs(1, k, m)
    w = (w.float() * (4e30 / (k * m)) ** 0.5).bfloat16()
    wj = jnp.asarray(w.float().numpy(), jnp.bfloat16)
    want = torch.from_numpy(np.array(PM.run(wj, aj, n, m))).bfloat16()
    got = ms.mma_chain(w, a, n)            # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == a.shape
    assert torch.equal(want[1:], a[1:8, 0:128])
    text, fails = _common.mma_readings(name, got[0:8, 0:128], want,
                                       a[0:8, 0:128])
    assert not fails, text


@pytest.mark.parametrize("name", list(ms.SHAPES))
def test_reference_matches_jnp_loop_at_a_visible_eps(name):
    """At the card check's eps the update moves every column's row 0; the
    plain version meets the jnp loop under the card's gates (both sum y^2 in
    f32, in their own orders), and the planted fault (a K row of w zeroed)
    reads over the mean gate by the required factor."""
    k, m = ms.SHAPES[name]
    w, a, wj, aj = _inputs(2, k, m)
    eps, n = _common.mma_eps(k, m), _common.MMA_CHECK_ITERS
    want = torch.from_numpy(np.array(
        _jnp_chain(wj, aj, n, eps).astype(jnp.float32))).bfloat16()
    got = ms.mma_chain(w, a, n, eps)
    bad = _common.mma_bad(
        w, a, lambda ww, aa: ms.mma_chain_reference(ww, aa, n, eps))
    text, fails = _common.mma_readings(name, got, want, a, bad)
    assert not fails, text


def test_probe_eps_changes_nothing():
    """At the probe's 1e-30 the bf16 add leaves a as it was: its output is
    the input, whatever the dots give."""
    w, a, _, _ = _inputs(3, 96, 96, 64)
    torch.testing.assert_close(ms.mma_chain(w, a, 4), a, rtol=0, atol=0)


def test_shapes_are_the_probes():
    assert ms.SHAPES == PM.SHAPES and ms.N_COLS == PM.N_LANES
    assert ms.EPS == 1e-30


def test_every_shape_fits_shared_memory_and_a_build():
    """w^T and a 16-column slice fit in a block's shared memory at every
    probe shape (k144_m630 is the largest, 190 KB of w^T), and every K pads
    to a k-step count the source is built for."""
    for k, m in ms.SHAPES.values():
        assert ms.smem_bytes(k, m) <= ms.SMEM_PER_BLOCK
        assert -(-k // 16) in ms.K_STEPS
    assert ms.smem_bytes(144, 630) == (640 + 16) * 152 * 2 + 8 * 16 * 4
    assert ms.padded(12, 192) == (16, 192) and ms.padded(132, 210) == (144,
                                                                      224)


def test_cpu_tensors_take_the_plain_version():
    w, a, _, _ = _inputs(4, 12, 192, 32)
    before = ms.mma_chain.launches
    torch.testing.assert_close(ms.mma_chain(w, a, 3, 1e-3),
                               ms.mma_chain_reference(w, a, 3, 1e-3), rtol=0,
                               atol=0)
    assert ms.mma_chain.launches == before


class _FakeCuda:
    """Stands in for a CUDA tensor in the guards, which read ``device``,
    ``dtype``, ``dim``, ``shape`` and ``is_contiguous`` before any
    launch."""

    def __init__(self, t, contiguous=True):
        self._t, self._c = t, contiguous
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._c


def test_cuda_call_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    w, a, _, _ = _inputs(5, 12, 192, 32)
    before = ms.mma_chain.launches
    with pytest.raises((RuntimeError, AssertionError)):
        ms.mma_chain(_FakeCuda(w), _FakeCuda(a), 2)
    assert ms.mma_chain.launches == before


GUARDS = [
    ("float32", dict(dtype=torch.float32), TypeError, "bfloat16"),
    ("a strided a", dict(contig=False), ValueError, "contiguous 2-D"),
    ("K of w and a differ", dict(a_rows=13), ValueError,
     "unsupported shapes"),
    ("K = 40 (3 k-steps)", dict(k=40), ValueError, "built for"),
    ("w^T over shared memory", dict(k=384, m=640), ValueError,
     "shared memory"),
]


@pytest.mark.parametrize("what,kw,exc,match", GUARDS,
                         ids=[g[0] for g in GUARDS])
def test_guards_raise(what, kw, exc, match):
    k, m = kw.get("k", 12), kw.get("m", 192)
    dt = kw.get("dtype", torch.bfloat16)
    w = torch.zeros((k, m), dtype=dt)
    a = torch.zeros((kw.get("a_rows", k), 32), dtype=dt)
    with pytest.raises(exc, match=match):
        ms.mma_chain(_FakeCuda(w), _FakeCuda(a, kw.get("contig", True)), 2)


def test_bound_is_the_useful_flops():
    bound, by = _common.mma_chain_bound(128, 128, 2048)
    assert by == "operations"
    assert bound == pytest.approx(2 * 128 * 128 * 2048 / 989e12 * 1e3)
