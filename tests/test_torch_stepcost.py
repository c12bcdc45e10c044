"""The plain version of the step-cost kernels (``aasist_tpu_torch/ops/
stepcost``) against ``tools/probe_stepcost.py:make_runner``, on the CPU.

The probe calls ``pl.pallas_call`` without ``interpret``; the tests patch it
to interpret mode, with nothing in ``tools/`` changed.  x and w come from
numpy seeds, rounded to bf16 once and handed to both sides as the same
values.  The constant modes and copy move stored values and must match
exactly; matmul and matblk sum the same exact bf16 products in f32 in
another order and round once, so they are held to one bf16 ulp (rtol 2^-7)
plus 1e-4 for the f32 order error near zero
(``tools/_common.py:stepcost_gate``, the gate the card's checks use).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from aasist_tpu_torch.ops import stepcost as sc
from aasist_tpu_torch.tools import _common
from aasist_tpu_torch.tools import probe_stepcost as pst

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools"))
import probe_stepcost as PS  # noqa: E402

# (B, T, G, u): a grid of 2 x 2 steps, and one with G = 16
GEOMETRIES = [(16, 512, 8, 256), (32, 256, 16, 128)]


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


def _inputs(seed, b, t, dtype=torch.bfloat16):
    """(x, w) as torch tensors of ``dtype`` holding bf16 values, and the
    same values as jax bf16 arrays."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.normal(0, 1, (32, b, 32, t)).astype(np.float32))
    w = torch.from_numpy(r.normal(0, 1, (96, 64)).astype(np.float32))
    x, w = x.bfloat16(), w.bfloat16()
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    wj = jnp.asarray(w.float().numpy(), jnp.bfloat16)
    return x.to(dtype), w.to(dtype), xj, wj


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["G8", "G16"])
@pytest.mark.parametrize("mode", sc.MODES)
def test_modes_match_jax(interpret_pallas, mode, geom):
    b, t, g, u = geom
    x, w, xj, wj = _inputs(1, b, t)
    want = np.asarray(PS.make_runner(mode, b, t, g, u)(xj, wj), np.float32)
    got = sc.stepcost(mode, x, w, g, u)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape == sc.out_shape(mode, b, t, g, u)
    atol, rtol = _common.stepcost_gate(mode)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)


def test_matblk_is_matmul_with_a_row_and_zero_padding():
    """matblk's rows 0..22 are matmul's, row 23 is one more row of the same
    function, rows 24..31 are zero, and the step-blocked layout holds a
    step's output in one contiguous region."""
    b, t, g, u = 4, 64, 2, 16
    x, w, _, _ = _inputs(2, b, t)
    mm = sc.stepcost_reference("matmul", x, w, g, u)
    blk = sc.stepcost_reference("matblk", x, w, g, u)
    # back to (32, B, 32, T)
    y = blk.permute(2, 0, 3, 4, 1, 5).reshape(32, b, 32, t)
    torch.testing.assert_close(y[:, :, :23], mm, rtol=0, atol=0)
    assert bool((y[:, :, 24:] == 0).all()) and bool((y[:, :, 23] != 0).any())
    step = blk[1, 2]                       # step (bb, jj) = (1, 2)
    assert step.is_contiguous()
    torch.testing.assert_close(step, y[:, 2:4, :, 32:48], rtol=0, atol=0)


@pytest.mark.parametrize("mode", sc.MODES)
def test_cpu_tensors_take_the_plain_version(mode):
    """A CPU tensor is no kernel launch and equals the plain version, also
    written into ``out``."""
    x, w, _, _ = _inputs(3, 4, 64)
    before = sc.stepcost.launches
    want = sc.stepcost_reference(mode, x, w, 2, 32)
    torch.testing.assert_close(sc.stepcost(mode, x, w, 2, 32), want, rtol=0,
                               atol=0)
    out = torch.full_like(want, float("nan"))
    assert sc.stepcost(mode, x, w, 2, 32, out=out) is out
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert sc.stepcost.launches == before


@pytest.mark.parametrize("mode", sc.MODES)
def test_cpu_tensors_take_the_plain_version_older(mode):
    """``stepcost_older`` on CPU tensors: no launch, the plain version, also
    written into ``out``."""
    x, w, _, _ = _inputs(3, 4, 64)
    before = sc.stepcost_older.launches
    want = sc.stepcost_reference(mode, x, w, 2, 32)
    torch.testing.assert_close(sc.stepcost_older(mode, x, w, 2, 32), want,
                               rtol=0, atol=0)
    out = torch.full_like(want, float("nan"))
    assert sc.stepcost_older(mode, x, w, 2, 32, out=out) is out
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert sc.stepcost_older.launches == before


class _FakeCuda:
    """Stands in for a CUDA tensor in the guards, which read ``device``,
    ``dtype``, ``dim``, ``shape``, ``is_contiguous`` and ``data_ptr`` before
    any launch."""

    def __init__(self, t, contiguous=True, ptr=None):
        self._t, self._c, self._ptr = t, contiguous, ptr
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._c

    def data_ptr(self):
        return self._t.data_ptr() if self._ptr is None else self._ptr


def test_cuda_call_without_a_card_raises():
    """With no card a call whose tensors claim to be there and pass every
    guard raises before any result comes back, with no launch counted."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, w, _, _ = _inputs(4, 4, 64)
    before = sc.stepcost.launches
    with pytest.raises((RuntimeError, AssertionError)):
        sc.stepcost("copy", _FakeCuda(x), _FakeCuda(w), 2, 32)
    assert sc.stepcost.launches == before


GUARDS = [
    ("float32 x", dict(dtype=torch.float32), TypeError, "bfloat16"),
    ("a strided x", dict(contig=False), ValueError, "contiguous"),
    ("a misaligned x", dict(ptr=8), ValueError, "16-byte aligned"),
    ("x of 31 rows", dict(x_shape=(32, 4, 31, 64)), ValueError,
     r"\(32, B, 32, T\)"),
    ("w of 63 columns", dict(w_shape=(96, 63)), ValueError, "w must be"),
    ("g not dividing B", dict(g=3), ValueError, "do not tile"),
    ("u not dividing T", dict(u=24), ValueError, "do not tile"),
    ("u of 4", dict(u=4), ValueError, "no multiple of 8"),
    ("a CPU out", dict(out_cpu=True), ValueError, "unsupported device"),
    ("a wrong out shape", dict(out_shape=(1, 2)), ValueError,
     "out must be"),
]


@pytest.mark.parametrize("what,kw,exc,match", GUARDS,
                         ids=[g[0] for g in GUARDS])
def test_guards_raise(what, kw, exc, match):
    x = torch.zeros(kw.get("x_shape", (32, 4, 32, 64)),
                    dtype=kw.get("dtype", torch.bfloat16))
    w = torch.zeros(kw.get("w_shape", (96, 64)), dtype=torch.bfloat16)
    out = None
    if kw.get("out_cpu"):
        out = torch.zeros(sc.out_shape("copy", 4, 64, 2, 32),
                          dtype=torch.bfloat16)
    elif "out_shape" in kw:
        out = _FakeCuda(torch.zeros(kw["out_shape"], dtype=torch.bfloat16))
    with pytest.raises(exc, match=match):
        sc.stepcost("copy", _FakeCuda(x, kw.get("contig", True),
                                      kw.get("ptr")),
                    _FakeCuda(w), kw.get("g", 2), kw.get("u", 32), out=out)


class _Built(Exception):
    """Raised in place of the build: every guard before it passed."""


@pytest.fixture
def builds(monkeypatch):
    """The (source, definitions) of every build a call asks for; the call
    then stops, as if the build had raised."""
    from aasist_tpu_torch.ops import _build
    seen = []

    def load(name, defines=None):
        seen.append((name, defines))
        raise _Built
    monkeypatch.setattr(_build, "load", load)
    return seen


@pytest.mark.parametrize("mode", sc.MODES)
def test_each_wrapper_launches_its_build(builds, mode):
    """``stepcost`` builds ``csrc/stepcost.cu`` plain (the TMA stores) and
    ``stepcost_older`` with ``STEPCOST_OLDER``, whose nop modes and copy are
    the kernels the TMA ones replaced; neither counts a launch that did not
    happen."""
    x, w, _, _ = _inputs(9, 4, 64)
    before = (sc.stepcost.launches, sc.stepcost_older.launches)
    for fn in (sc.stepcost, sc.stepcost_older):
        with pytest.raises(_Built):
            fn(mode, _FakeCuda(x), _FakeCuda(w), 2, 32)
    assert builds == [("stepcost", None),
                      ("stepcost", {"STEPCOST_OLDER": None})]
    assert (sc.stepcost.launches, sc.stepcost_older.launches) == before
    assert sc.TMA_MODES == ("nop", "nopF32", "nopblk", "copy")


@pytest.mark.parametrize("mode", sc.MODES)
def test_ragged_geometry_passes_the_tma_guards(builds, mode):
    """The card check's ragged geometry, (B, T, g, u) = (6, 312, 3, 104),
    meets TMA's conditions (T = 312 makes 624-byte row strides, u = 104
    208-byte box rows) and reaches the build in both wrappers."""
    x, w, _, _ = _inputs(10, 6, 312)
    for fn in (sc.stepcost, sc.stepcost_older):
        with pytest.raises(_Built):
            fn(mode, _FakeCuda(x), _FakeCuda(w), 3, 104)
    assert len(builds) == 2


TMA_GUARDS = [
    ("T of 12: 24-byte row strides", dict(t=12, u=4), "no multiple of 16"),
    ("u of 4", dict(t=64, u=4), "no multiple of 8"),
    ("a misaligned x", dict(x_ptr=8), "16-byte aligned"),
    ("a misaligned out", dict(out_ptr=8), "16-byte aligned"),
]


@pytest.mark.parametrize("fn", ["stepcost", "stepcost_older"])
@pytest.mark.parametrize("what,kw,match", TMA_GUARDS,
                         ids=[g[0] for g in TMA_GUARDS])
def test_tma_guards_raise_before_any_launch(builds, fn, what, kw, match):
    """What TMA does not take (a global stride or a box row that is no
    multiple of 16 bytes, an address off a 16-byte boundary) raises
    ``ValueError`` before the build is asked for and before any launch."""
    t, u = kw.get("t", 64), kw.get("u", 32)
    x = torch.zeros((32, 4, 32, t), dtype=torch.bfloat16)
    w = torch.zeros((96, 64), dtype=torch.bfloat16)
    out = None
    if "out_ptr" in kw:
        out = _FakeCuda(torch.zeros(sc.out_shape("nop", 4, t, 2, u),
                                    dtype=torch.bfloat16), ptr=kw["out_ptr"])
    wrapper = getattr(sc, fn)
    before = wrapper.launches
    with pytest.raises(ValueError, match=match):
        wrapper("nop", _FakeCuda(x, ptr=kw.get("x_ptr")), _FakeCuda(w), 2, u,
                out=out)
    assert builds == [] and wrapper.launches == before


def test_unknown_mode_raises():
    x, w, _, _ = _inputs(5, 2, 16)
    for fn in (sc.stepcost, sc.stepcost_older, sc.stepcost_reference):
        with pytest.raises(ValueError, match="not one of"):
            fn("nopbf16", x, w, 1, 8)


@pytest.mark.parametrize("mode,ms", [
    ("nop", 0.403), ("nopF32", 0.561), ("nopblk", 0.561), ("copy", 0.806),
    ("matmul", 0.859), ("matblk", 1.034)])
def test_bounds_at_block0s_grid(mode, ms):
    """B = 128, T = 7168 in bf16: every mode is bound by its bytes, the dots
    by the 26 (matmul) and 27 (matblk) rows of x their output depends on;
    their FLOPs, both halves' dots at the 23 and 24 output rows, would take
    0.262 and 0.274 ms."""
    bound, by = _common.stepcost_bound(mode, 128, 7168)
    assert by == "bytes" and bound == pytest.approx(ms, abs=5e-4)
    flops = _common.stepcost_flops(mode, 128, 7168)
    want = {"matmul": 0.262, "matblk": 0.274}.get(mode, 0.0)
    assert flops / _common.PEAK_FLOPS["bfloat16"] * 1e3 == pytest.approx(
        want, abs=5e-4)


def test_dots_rows_are_what_the_output_reads():
    """Changing x at the first row past the rows counted in the bound leaves
    the dots' outputs as they were; changing the last counted row does
    not."""
    b, t, g, u = 2, 16, 1, 8
    x, w, _, _ = _inputs(8, b, t)
    for mode in ("matmul", "matblk"):
        rows = _common.STEPCOST_ROWS[mode][0]
        want = sc.stepcost_reference(mode, x, w, g, u)
        past, last = x.clone(), x.clone()
        past[:, :, rows:] = 0
        last[:, :, rows - 1] = 0
        assert torch.equal(sc.stepcost_reference(mode, past, w, g, u), want)
        assert not torch.equal(sc.stepcost_reference(mode, last, w, g, u),
                               want)


@pytest.mark.parametrize("mode", sc.MODES)
def test_gate_passes_the_plain_version_and_tells_the_fault(mode):
    """On plain versions: the readings pass a version against itself, and
    the planted fault of every mode puts elements over the gate; an output
    left unwritten (NaN) is caught too."""
    b, t, g, u = 4, 64, 2, 16
    x, w, _, _ = _inputs(6, b, t)

    def run(xx, ww):
        return sc.stepcost_reference(mode, xx, ww, g, u)
    plain = run(x, w)
    bad = _common.stepcost_bad(mode, x, w, run)
    text, fails = _common.stepcost_readings(mode, plain.clone(), plain, bad)
    assert not fails, text
    text, fails = _common.stepcost_readings(
        mode, torch.full_like(plain, float("nan")), plain)
    assert fails and f"{plain.numel()} elements" in fails[0]


def test_stock_conv_computes_matmuls_function():
    """The timed stock call for matmul and matblk, ``F.conv2d`` with the
    halves' weights summed into a (4, 1) kernel, is the same function (in
    float32, where the summed taps are exact)."""
    b, t = 2, 24
    x, w, _, _ = _inputs(7, b, t, torch.float32)
    calls = pst.library_calls(x, w)
    for mode, rows in (("matmul", 23), ("matblk", 24)):
        got = calls[mode]().permute(1, 0, 2, 3)
        assert tuple(got.shape) == (32, b, rows, t)
        want = sc._dots(x, w, rows)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(calls["copy"](), x[:, :, :23])
