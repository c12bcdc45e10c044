"""The Scorer's bf16 kernels, on the CPU: the tensor-core frontend's plain
and padded stores (``ops/frontend_variants.py``) and the warp-specialised
block 0 (``ops/block0_pipe.py``).

Their plain versions against the JAX package (the frontend's Pallas kernel
as ``tests/test_torch_layers.py`` runs it, the frontend + block-0 pair of
``tools/fused_stack.py`` in interpret mode); the kernels' work
decompositions, which the wrappers pass to them, cover every output once;
the phase timer's reader on a made-up buffer; the routing by type, the
launch counts and the guards.
"""

import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aasist_tpu.models.layers import sinc_filterbank
from aasist_tpu.ops.fused_frontend import fused_frontend as jax_fused_frontend

from aasist_tpu_torch.models.layers import ResidualBlock
from aasist_tpu_torch.ops import block0_f32 as b32
from aasist_tpu_torch.ops import block0_pipe as bp
from aasist_tpu_torch.ops import frontend_f32 as f32
from aasist_tpu_torch.ops import frontend_variants as fv
from aasist_tpu_torch.ops import fused_frontend as fe
from aasist_tpu_torch.ops import fused_stack as fs
from aasist_tpu_torch.weights import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools"))
import fused_stack as FS  # noqa: E402

C = 32
FE_P = {"weight": np.asarray([1.3], np.float32),
        "bias": np.asarray([0.2], np.float32)}
FE_S = {"mean": np.asarray([0.1], np.float32),
        "var": np.asarray([1.5], np.float32)}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _bn():
    return ({k: _t(v) for k, v in FE_P.items()},
            {k: _t(v) for k, v in FE_S.items()})


def _block0_params(seed):
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
    return p, s


def _block(seed=0):
    return load_jax_params(ResidualBlock(1, C, first=True),
                           *_block0_params(seed)).eval()


# ----------------------------------------------------- against JAX
@pytest.mark.parametrize("b,length,masked", [(2, 2400, False),
                                             (3, 4000, True)])
def test_dot_plain_and_padded_match_the_jax_frontend(b, length, masked):
    """The plain and padded stores' plain versions (the CPU route) against
    the Pallas frontend, at its gate (atol 1e-4); the padded frame's border
    is exactly zero."""
    rng = np.random.default_rng(20 + b)
    x = (rng.standard_normal((b, length)) * 0.1).astype(np.float32)
    bank = sinc_filterbank(70, 129, 16000).astype(np.float32)
    if masked:
        bank[10:20] = 0
    ref = np.asarray(jax_fused_frontend(jnp.asarray(x), jnp.asarray(bank),
                                        FE_P, FE_S), np.float32)
    bn_p, bn_s = _bn()
    plain = fv.fused_frontend_dot_plain(_t(x), _t(bank), bn_p, bn_s).numpy()
    padded = fv.fused_frontend_dot_padded(_t(x), _t(bank), bn_p,
                                          bn_s).numpy()
    t_out = (length - 128) // 3
    assert plain.shape == ref.shape == (b, 1, 23, t_out)
    assert padded.shape == (b, 25, t_out + 2)
    np.testing.assert_allclose(plain, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(padded[:, 1:-1, 1:-1], ref[:, 0], atol=1e-4,
                               rtol=0)
    border = np.concatenate([padded[:, [0, -1]].ravel(),
                             padded[:, :, [0, -1]].ravel()])
    assert not border.any()


def test_block0_pipe_matches_the_jax_pair():
    """block0_pipe's plain version on the padded frame against the Pallas
    frontend + block-0 pair, f32, at the JAX test's gate: max error / max
    |ref| < 5e-5."""
    p, s = _block0_params(0)
    bank = sinc_filterbank(70, 129, 16000).astype(np.float32)
    b, length = 2, 2400
    x = np.random.default_rng(1).normal(0, 1, (b, length)).astype(np.float32)
    fsp = FS.FusedStackParams(bank, FE_P, FE_S, p, s, dtype=jnp.float32)
    ref = np.asarray(FS.fused_frontend_block0(jnp.asarray(x), fsp),
                     np.float32)
    block = load_jax_params(ResidualBlock(1, C, first=True), p, s).eval()
    bn_p, bn_s = _bn()
    with torch.inference_mode():
        z = fv.fused_frontend_dot_padded(_t(x), _t(bank), bn_p, bn_s)
        got = bp.block0_pipe(z, block).numpy()
    assert got.shape == ref.shape == (b, C, 23, (length - 128) // 9)
    err = np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-6)
    assert err < 5e-5, f"rel err {err:.2e}"


# ------------------------------------------------ work decompositions
def _cover(items, shape):
    seen = np.zeros(shape, np.int32)
    for item in items:
        b, (f0, f1), (t0, t1) = item[0], item[1:3], item[3:5]
        assert 0 <= f0 < f1 <= shape[1] and 0 <= t0 < t1 <= shape[2]
        seen[b, f0:f1, t0:t1] += 1
    return seen


@pytest.mark.parametrize("b,f,t_out", [(128, 23, 7163), (3, 23, 1763),
                                       (2, 30, 40)],
                         ids=["main path", "ragged L=16001", "two bands"])
def test_block0_pipe_work_covers_each_output_once(b, f, t_out):
    n_tiles, n_bands, n_work = bp.pipe_work(b, f, t_out)
    assert n_tiles == -(-t_out // 16) and n_bands == -(-f // 23)
    assert n_work == b * n_bands * n_tiles
    seen = _cover(bp.pipe_items(b, f, t_out), (b, f, t_out))
    assert (seen == 1).all()


def _dot_source_tile(source):
    """The pooled columns of a work item as the source states them."""
    from aasist_tpu_torch.ops import _build

    text = (_build.CSRC / f"{source}.cu").read_text()
    const = {m[1]: m[2] for m in re.finditer(
        r"constexpr int (\w+) = ([^;]+);", text)}
    if const["TILE"] == "16 * SUB * WARPS":           # csrc/frontend_dot.cu
        return 16 * int(const["SUB"]) * int(const["WARPS"])
    return int(const["TILE"])


@pytest.mark.parametrize("source", ["frontend_dot_wg", "frontend_dot"])
@pytest.mark.parametrize("b,length", [(128, 64600), (3, 16001)])
def test_frontend_dot_work_covers_each_output_once(b, length, source):
    """Both sources' items (the wgmma kernel's and the older one's) are
    ``dot_work``'s: their TILE is ``DOT_TILE``, and the items cover each
    output column once."""
    assert _dot_source_tile(source) == fv.DOT_TILE
    t_out = (length - 128) // 3
    n_tiles, n_work = fv.dot_work(b, length)
    assert n_tiles == -(-t_out // fv.DOT_TILE) and n_work == b * n_tiles
    items = ((bb, 0, 1, t0, t1) for bb, t0, t1 in fv.dot_items(b, length))
    assert (_cover(items, (b, 1, t_out)) == 1).all()


# --------------------------------------------------------- the timer
def _timer_row(clk0, ghz, ns, items, phases):
    """A CTA's row: it lives ``ns`` ns at ``ghz`` clocks a ns."""
    row = [clk0, clk0 + int(ns * ghz), 1000, 1000 + ns, items] + [0] * 7
    for slot, ms in phases.items():
        row[slot] = int(ms * 1e6 * ghz)
    return row


def test_phase_ms_reads_a_made_up_buffer():
    """Two CTAs at different clock rates and one with no item: each phase's
    clocks turn into ms at its own CTA's rate, then are averaged."""
    a = {5: 0.5, 6: 0.1, 7: 0.2, 8: 2.0, 9: 0.3, 10: 1.5, 11: 1.0}
    b = {k: 2 * v for k, v in a.items()}
    buf = [_timer_row(10 ** 9, 1.5, 3_000_000, 400, a),
           _timer_row(5, 2.0, 6_000_000, 420, b),
           [0] * 12]
    got = bp.phase_ms(buf, "pipe")
    for slot, name in bp.TIMER_PHASES["pipe"].items():
        assert got[name] == pytest.approx(1.5 * a[slot], rel=1e-6)
    assert got["cta"] == pytest.approx(4.5)
    assert got["clock_ghz"] == pytest.approx(1.75)
    old = bp.phase_ms([_timer_row(0, 1.98, 7_000_000, 652,
                                  {5: 1.0, 6: 3.0, 7: 2.0, 8: 1.0})], "mma")
    assert list(old)[:4] == list(bp.TIMER_PHASES["mma"].values())
    assert [round(v, 6) for v in list(old.values())[:4]] == [1, 3, 2, 1]
    with pytest.raises(ValueError, match="no CTA"):
        bp.phase_ms([[0] * 12], "pipe")


def test_timer_layout_lives_in_one_header():
    """Both block-0 sources take the side buffer from csrc/b0_timer.cuh, whose
    words per CTA and slots the reader uses, and define none of their own."""
    from aasist_tpu_torch.ops import _build
    header = (_build.CSRC / "b0_timer.cuh").read_text()
    assert int(re.search(r"constexpr int NSLOT = (\d+);", header)[1]) \
        == bp.TIMER_SLOTS
    for kernel in bp.TIMER_PHASES.values():
        assert set(kernel) <= set(range(5, bp.TIMER_SLOTS))
    for src in ("block0_pipe.cu", "fused_block0.cu"):
        text = (_build.CSRC / src).read_text()
        assert '#include "b0_timer.cuh"' in text
        assert not re.search(r"g_timer\[|NSLOT =|g_timer_grid =", text)


def test_build_hashes_the_headers(tmp_path, monkeypatch):
    """An edited header names a new library for the sources that include
    it, so no build of the old header is reused."""
    from aasist_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        raise RuntimeError("stop before nvcc")

    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    for edit in (False, True):
        if edit:
            with open(csrc / "b0_timer.cuh", "a") as f:
                f.write("// edited\n")
        with pytest.raises(RuntimeError, match="stop before nvcc"):
            _build.load("block0_pipe", bp.TIMER_DEFINES)
    outs = [cmd[cmd.index("-o") + 1] for cmd in calls]
    assert len(outs) == 2 and outs[0] != outs[1]


# ------------------------------------------- routes, counts, guards
def _args(b=2, length=1000):
    x = _t(np.random.default_rng(6).normal(0, 1, (b, length)))
    bank = _t(sinc_filterbank(70, 129, 16000))
    return (x, bank, *_bn())


# every kernel wrapper a Scorer path can reach; the routers count nothing
KERNELS = [(fv, "fused_frontend_dot_plain"), (fv, "fused_frontend_dot_padded"),
           (fe, "fused_frontend_fma"), (fs, "fused_frontend_padded_fma"),
           (bp, "block0_pipe"), (fs, "fused_block0_mma"),
           (fs, "fused_block0_fma"), (f32, "fused_frontend_tf32x3"),
           (f32, "fused_frontend_padded_tf32x3"), (b32, "block0_tf32x3"),
           (f32, "fused_frontend_ffma"), (f32, "fused_frontend_padded_ffma")]


def _counts():
    return [getattr(m, n).launches for m, n in KERNELS]


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor is no kernel launch; each wrapper equals its plain
    version there."""
    x, bank, bn_p, bn_s = _args()
    block = _block(3)
    before = _counts()
    with torch.inference_mode():
        z = fs.fused_frontend_padded(x, bank, bn_p, bn_s)
        torch.testing.assert_close(
            fv.fused_frontend_dot_plain(x, bank, bn_p, bn_s),
            fe.fused_frontend_reference(x, bank, bn_p, bn_s), rtol=0, atol=0)
        torch.testing.assert_close(
            fv.fused_frontend_dot_padded(x, bank, bn_p, bn_s),
            fv.fused_frontend_dot_padded_reference(x, bank, bn_p, bn_s),
            rtol=0, atol=0)
        torch.testing.assert_close(z, fs.fused_frontend_padded_reference(
            x, bank, bn_p, bn_s), rtol=0, atol=0)
        ref = fs.fused_block0_reference(z, block)
        for fn in (bp.block0_pipe, fs.fused_block0_mma, fs.fused_block0_fma):
            torch.testing.assert_close(fn(z, block), ref, rtol=0, atol=0)
    assert _counts() == before


class _FakeCuda:
    """Stands in for a CUDA tensor in the guards, which read ``device``,
    ``dtype``, ``dim``, ``shape`` and ``is_contiguous`` before any launch."""

    def __init__(self, t, contiguous=True):
        self._t, self._c = t, contiguous
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._c


# float32's case keeps the id it had when both stores took the CUDA-core
# kernel: the plain store now takes the CUDA-core redesign, the padded one
# the 3xTF32 kernel
_F32_ROUTES = {"fused_frontend": "fused_frontend_ffma",
               "fused_frontend_padded": "fused_frontend_padded_tf32x3"}


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "fused_frontend_dot_"),
    pytest.param(torch.float32, _F32_ROUTES,
                 id="dtype1-fused_frontend_(padded_)?fma"),
    (torch.float16, "fused_frontend_(padded_)?fma")])
@pytest.mark.parametrize("router", ["fused_frontend", "fused_frontend_padded"])
def test_frontends_route_by_type(router, dtype, kernel):
    """On a card, bf16 goes to the bf16 tensor-core kernel, float32's plain
    store to the CUDA-core redesign and its padded store to the 3xTF32
    kernel, anything else to the older CUDA-core kernel: the guards of the
    kernel picked name it (a strided waveform here), and nothing is
    counted."""
    if isinstance(kernel, dict):
        kernel = f"{kernel[router]}:"
    fn = getattr(fe if router == "fused_frontend" else fs, router)
    x = _FakeCuda(torch.zeros((2, 1000), dtype=dtype), contiguous=False)
    bank = _FakeCuda(torch.zeros((70, 129), dtype=dtype))
    bn_p, bn_s = _bn()
    before = _counts()
    with pytest.raises((ValueError, TypeError), match=kernel):
        fn(x, bank, bn_p, bn_s)
    assert _counts() == before


@pytest.mark.parametrize("dtype,kernel,exc", [
    (torch.bfloat16, "block0_pipe", ValueError),
    pytest.param(torch.float32, "block0_tf32x3", ValueError,
                 id="dtype1-fused_block0_fma-ValueError"),
    (torch.float16, "fused_block0_fma", TypeError)])
def test_block0_routes_by_type(dtype, kernel, exc):
    z = _FakeCuda(torch.zeros((2, 25, 300), dtype=dtype), contiguous=False)
    before = _counts()
    with pytest.raises(exc, match=kernel):
        fs.fused_block0(z, _block())
    assert _counts() == before


@pytest.mark.parametrize("name,dtype,shape,contig,exc,match", [
    ("block0_pipe", torch.float32, (2, 25, 300), True, TypeError,
     "bfloat16"),
    ("block0_pipe", torch.bfloat16, (2, 25, 300), False, ValueError,
     "contiguous"),
    ("block0_pipe", torch.bfloat16, (2, 25, 4), True, ValueError,
     "unsupported frame"),
    ("fused_block0_mma", torch.float32, (2, 25, 300), True, TypeError,
     "bfloat16"),
    ("fused_block0_fma", torch.bfloat16, (2, 25, 300), True, TypeError,
     "float32"),
])
def test_block0_guards_raise(name, dtype, shape, contig, exc, match):
    fn = getattr(bp if name == "block0_pipe" else fs, name)
    before = fn.launches
    with pytest.raises(exc, match=match):
        fn(_FakeCuda(torch.zeros(shape, dtype=dtype), contig), _block())
    assert fn.launches == before


@pytest.mark.parametrize("layout", ["plain", "padded"])
def test_dot_stores_refuse_float32(layout):
    fn = getattr(fv, f"fused_frontend_dot_{layout}")
    x = _FakeCuda(torch.zeros((2, 1000)))
    bank = _FakeCuda(torch.zeros((70, 129)))
    with pytest.raises(TypeError, match="bfloat16 only"):
        fn(x, bank, *_bn())


def test_timing_builds_have_no_plain_version():
    """The cut and timer builds run on a card only: a CPU frame raises, an
    unknown cut or kernel too, and nothing is counted."""
    z = torch.zeros((2, 25, 300), dtype=torch.bfloat16)
    before = (bp.block0_pipe_cut.launches, bp.block0_timed.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        bp.block0_pipe_cut(z, _block(), "skeleton")
    with pytest.raises(ValueError, match="unknown cut"):
        bp.block0_pipe_cut(z, _block(), "no_store")
    with pytest.raises(ValueError, match="unsupported device"):
        bp.block0_timed(z, _block(), "pipe")
    with pytest.raises(ValueError, match="unsupported device"):
        bp.block0_timed(z, _block(), "mma")
    with pytest.raises(ValueError, match="unknown kernel"):
        bp.block0_timed(_FakeCuda(z), _block(), "wgmma")
    assert (bp.block0_pipe_cut.launches, bp.block0_timed.launches) == before
