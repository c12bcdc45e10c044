"""The port's frontend probes' kernels' plain versions
(``aasist_tpu_torch/ops/frontend_variants``, ``ops/frontend_head``) against
the JAX probes, on the CPU.

``tools/probe_frontend_variants.py:run_v2`` and ``tools/probe_fe_fix.py:
fe_v2bm`` call ``pl.pallas_call`` without ``interpret``; the tests patch
``pl.pallas_call`` to interpret mode before the first call, with nothing in
``tools/`` changed.  ``tools/probe_feb0_ablate.py`` defines its kernel
inside ``main()``, which loads the checkpoint and times batches of 128, so
the head is held against its plain JAX chain instead: the fused frontend in
interpret mode, then conv1, bn2 and SELU as ``residual_block_apply`` runs
them.  Inputs and weights come from numpy seeds; the probes are imported
from ``tools/`` through ``sys.path``.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from aasist_tpu import nn as jnn
from aasist_tpu.models.layers import sinc_filterbank
from aasist_tpu.nn import BN_EPS
from aasist_tpu.ops import fused_frontend as FF

from aasist_tpu_torch.models.layers import ResidualBlock
from aasist_tpu_torch.ops import frontend_head as fh
from aasist_tpu_torch.ops import frontend_variants as fv
from aasist_tpu_torch.weights import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools"))
import probe_fe_fix as PFF  # noqa: E402
import probe_frontend_variants as PFV  # noqa: E402

C = 32
FE_P = {"weight": np.asarray([1.3], np.float32),
        "bias": np.asarray([0.2], np.float32)}
FE_S = {"mean": np.asarray([0.1], np.float32),
        "var": np.asarray([1.5], np.float32)}


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


def _bank(masked):
    bank = sinc_filterbank(70, 129, 16000).astype(np.float32)
    if masked:
        bank[10:20] = 0
    return bank


def _x(seed, b, length):
    return np.random.default_rng(seed).normal(0, 1, (b, length)).astype(
        np.float32)


def _torch_bn():
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    return t(FE_P), t(FE_S)


@functools.lru_cache(maxsize=None)
def _run_v2(b, length, masked):
    """``run_v2``'s output and T (interpret mode, under the caller's
    ``interpret_pallas``), computed once for both wrappers."""
    bank, x, u = _bank(masked), _x(1, b, length), 256
    xt, t_out = PFV.make_xt(jnp.asarray(x), u)
    inv = 1.0 / np.sqrt(FE_S["var"][0] + BN_EPS)
    sc = np.asarray([[FE_P["weight"][0] * inv,
                      FE_P["bias"][0] - FE_S["mean"][0] * FE_P["weight"][0]
                      * inv]], np.float32)
    ref = np.asarray(PFV.run_v2(xt, jnp.asarray(FF.pack_filterbank(bank)),
                                jnp.asarray(sc), b, u, 70))
    assert ref.shape == (24, b, xt.shape[0] * u)
    return ref, t_out


@functools.lru_cache(maxsize=None)
def _fe_v2bm(b, length, masked):
    bank, x = _bank(masked), _x(2, b, length)
    return np.asarray(PFF.fe_v2bm(jnp.asarray(x), jnp.asarray(bank), FE_P,
                                  FE_S, u=256))


@pytest.mark.parametrize("name", ["fused_frontend_dot_fm",
                                  "fused_frontend_dot_fm_older"])
@pytest.mark.parametrize("b,length,masked", [(2, 2400, False),
                                             (3, 4000, True)])
def test_dot_fm_matches_run_v2(interpret_pallas, b, length, masked, name):
    """``fused_frontend_dot_fm`` and its ``_older`` twin (plain route)
    against the filter-major Pallas kernel, f32, atol 1e-4 (the JAX
    kernel's own gate); row 23 is exactly zero on both sides."""
    bank, x = _bank(masked), _x(1, b, length)
    ref, t_out = _run_v2(b, length, masked)

    bn_p, bn_s = _torch_bn()
    got = getattr(fv, name)(torch.from_numpy(x), torch.from_numpy(bank),
                            bn_p, bn_s).numpy()
    assert got.shape == (24, b, t_out) and t_out == (length - 128) // 3
    np.testing.assert_allclose(got, ref[:, :, :t_out], atol=1e-4, rtol=0)
    assert np.all(got[23] == 0) and np.all(ref[23] == 0)
    assert np.all(np.abs(got[:23]).max(axis=(1, 2)) > 0)


@pytest.mark.parametrize("name", ["fused_frontend_dot_bm",
                                  "fused_frontend_dot_bm_older"])
@pytest.mark.parametrize("b,length,masked", [(2, 2400, True),
                                             (3, 4000, False)])
def test_dot_bm_matches_fe_v2bm(interpret_pallas, b, length, masked, name):
    """``fused_frontend_dot_bm`` and its ``_older`` twin (plain route)
    against the batch-major Pallas kernel through ``fe_v2bm``, f32, atol
    1e-4; the port's row 23 is exactly zero, and ``out[:, None, :23]`` is
    the frontend's output."""
    bank, x = _bank(masked), _x(2, b, length)
    ref = _fe_v2bm(b, length, masked)
    t_out = (length - 128) // 3
    assert ref.shape == (b, 1, 23, t_out)

    bn_p, bn_s = _torch_bn()
    got = getattr(fv, name)(torch.from_numpy(x), torch.from_numpy(bank),
                            bn_p, bn_s)
    assert tuple(got.shape) == (b, 24, t_out)
    np.testing.assert_allclose(got[:, None, :23].numpy(), ref, atol=1e-4,
                               rtol=0)
    assert bool((got[:, 23] == 0).all())
    assert bool((got[:, :23].abs().amax(dim=(0, 2)) > 0).all())
    # the two layouts hold the same values
    fm = getattr(fv, name.replace("_bm", "_fm"))(
        torch.from_numpy(x), torch.from_numpy(bank), bn_p, bn_s)
    torch.testing.assert_close(fm.permute(1, 0, 2), got, rtol=0, atol=0)


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


@pytest.mark.parametrize("b,length,masked", [(2, 2400, False),
                                             (3, 4000, True)])
def test_head_matches_jax_chain(b, length, masked):
    """``fused_frontend_head`` (plain route) against the JAX chain: the
    fused frontend in interpret mode, then conv1 with padding (1,1), eval
    bn2 and SELU; max error / max |ref| < 5e-5 for y1, atol 1e-4 for x0,
    whose row 23 is exactly zero."""
    bank, x = _bank(masked), _x(3, b, length)
    p, s = _block0_params(4)
    h = FF.fused_frontend(jnp.asarray(x), jnp.asarray(bank), FE_P, FE_S,
                          u=256)
    y = jnn.conv2d(p["conv1"], h, padding=((1, 1), (1, 1)))
    y, _ = jnn.batch_norm(p["bn2"], s["bn2"], y, axis=1, train=False)
    ref_y1, ref_x0 = np.asarray(jax.nn.selu(y)), np.asarray(h)

    block = load_jax_params(ResidualBlock(1, C, first=True), p, s).eval()
    bn_p, bn_s = _torch_bn()
    with torch.inference_mode():
        y1, x0 = fh.fused_frontend_head(torch.from_numpy(x),
                                        torch.from_numpy(bank), bn_p, bn_s,
                                        block)
    t_out = (length - 128) // 3
    assert tuple(y1.shape) == ref_y1.shape == (b, C, 24, t_out)
    assert tuple(x0.shape) == (b, 24, t_out)
    err = np.max(np.abs(y1.numpy() - ref_y1)) / np.max(np.abs(ref_y1))
    assert err < 5e-5, f"rel err {err:.2e}"
    np.testing.assert_allclose(x0[:, None, :23].numpy(), ref_x0, atol=1e-4,
                               rtol=0)
    assert bool((x0[:, 23] == 0).all())


def _cpu_args(seed=5, b=2, length=1000):
    bn_p, bn_s = _torch_bn()
    return (torch.from_numpy(_x(seed, b, length)),
            torch.from_numpy(_bank(False)), bn_p, bn_s)


def test_head_edges_are_not_masked():
    """y1 at t = 0, t = T - 1 and rows 0 and 23 is what conv1 + bn2 + SELU
    give on the zero-padded frame, the folded shift included: SELU of the
    shift where every neighbour is zero, never a stored zero."""
    x, bank, bn_p, bn_s = _cpu_args()
    p, s = _block0_params(6)
    block = load_jax_params(ResidualBlock(1, C, first=True), p, s).eval()
    with torch.inference_mode():
        y1, x0 = fh.fused_frontend_head(x, bank, bn_p, bn_s, block)
        prm = fh.fs.fold_block0(block)
        frame = torch.nn.functional.pad(x0[:, None, :23], (1, 1, 1, 1))
        want = torch.selu(torch.nn.functional.conv2d(
            frame, prm.w1.reshape(C, 1, 2, 3)) + prm.shift1[:, None, None])
    torch.testing.assert_close(y1, want, atol=2e-5, rtol=1e-5)
    assert bool((y1[:, :, :, 0] != 0).all())
    assert bool((y1[:, :, :, -1] != 0).all())


HEADS = ("fused_frontend_head", "fused_frontend_head_older")
DOTS = ("fused_frontend_dot_fm", "fused_frontend_dot_bm",
        "fused_frontend_dot_fm_older", "fused_frontend_dot_bm_older")


@pytest.mark.parametrize("name", [*DOTS, *HEADS])
def test_cpu_tensors_take_the_plain_versions(name):
    """A CPU tensor is no kernel launch and equals the plain version (the
    older head's is the new one's); a device that is neither CPU nor CUDA
    raises."""
    x, bank, bn_p, bn_s = _cpu_args()
    extra = ()
    if name in HEADS:
        mod = fh
        extra = (load_jax_params(ResidualBlock(1, C, first=True),
                                 *_block0_params(7)).eval(),)
    else:
        mod = fv
    fn = getattr(mod, name)
    ref_fn = getattr(mod, name.replace("_older", "") + "_reference")
    before = fn.launches
    with torch.inference_mode():
        got = fn(x, bank, bn_p, bn_s, *extra)
        ref = ref_fn(x, bank, bn_p, bn_s, *extra)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert fn.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fn(x.to("meta"), bank.to("meta"), bn_p, bn_s, *extra)


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


@pytest.mark.parametrize("name", [*DOTS, *HEADS])
def test_cuda_call_without_a_card_raises(name):
    """With no card there is no way to the plain version through the
    ``cuda`` device: moving the tensors there raises, and a call whose
    tensors claim to be on the card and pass every guard raises before any
    result comes back, with no launch counted."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, bank, bn_p, bn_s = _cpu_args()
    extra = ((ResidualBlock(1, C, first=True).eval(),)
             if name in HEADS else ())
    fn = getattr(fh if extra else fv, name)
    with pytest.raises((RuntimeError, AssertionError)):
        fn(x.to("cuda"), bank.to("cuda"), bn_p, bn_s, *extra)
    dtype = torch.float32 if extra else torch.bfloat16
    before = fn.launches
    with pytest.raises((RuntimeError, TypeError)):
        fn(_FakeCuda(x.to(dtype)), _FakeCuda(bank.to(dtype)), bn_p, bn_s,
           *extra)
    assert fn.launches == before


GUARDS = [
    ("float32 to the bf16-only kernel", torch.float32, (2, 1000), (70, 129),
     True, TypeError, "bfloat16 only"),
    ("a 3-D waveform", torch.bfloat16, (2, 1, 1000), (70, 129), True,
     ValueError, "expected x"),
    ("a bank of 128 taps", torch.bfloat16, (2, 1000), (70, 128), True,
     ValueError, "expected x"),
    ("a strided waveform", torch.bfloat16, (2, 1000), (70, 129), False,
     ValueError, "contiguous"),
    ("too short a waveform", torch.bfloat16, (2, 130), (70, 129), True,
     ValueError, "unsupported shape"),
    ("more than 24 pooled rows", torch.bfloat16, (2, 1000), (75, 129), True,
     ValueError, "unsupported shape"),
]


@pytest.mark.parametrize("what,dtype,xshape,bshape,contig,exc,match", GUARDS,
                         ids=[g[0] for g in GUARDS])
@pytest.mark.parametrize("name", DOTS)
def test_dot_guards_raise(name, what, dtype, xshape, bshape, contig, exc,
                          match):
    x = _FakeCuda(torch.zeros(xshape, dtype=dtype), contig)
    bank = _FakeCuda(torch.zeros(bshape, dtype=dtype))
    bn_p, bn_s = _torch_bn()
    with pytest.raises(exc, match=match):
        getattr(fv, name)(x, bank, bn_p, bn_s)


HEAD_GUARDS = [
    ("float16", torch.float16, (2, 1000), (70, 129), True, C, TypeError,
     "not supported"),
    ("a 1-D waveform", torch.float32, (1000,), (70, 129), True, C,
     ValueError, "expected x"),
    ("a strided bank", torch.float32, (2, 1000), (70, 129), False, C,
     ValueError, "contiguous"),
    ("too short a waveform", torch.float32, (2, 129), (70, 129), True, C,
     ValueError, "unsupported shape"),
    ("a block of 8 channels", torch.float32, (2, 1000), (70, 129), True, 8,
     ValueError, "takes 32 channels"),
]


@pytest.mark.parametrize("what,dtype,xshape,bshape,contig,ch,exc,match",
                         HEAD_GUARDS, ids=[g[0] for g in HEAD_GUARDS])
def test_head_guards_raise(what, dtype, xshape, bshape, contig, ch, exc,
                           match):
    x = _FakeCuda(torch.zeros(xshape, dtype=dtype))
    bank = _FakeCuda(torch.zeros(bshape, dtype=dtype), contig)
    bn_p, bn_s = _torch_bn()
    block = ResidualBlock(1, ch, first=True).eval()
    with pytest.raises(exc, match=match):
        fh.fused_frontend_head(x, bank, bn_p, bn_s, block)


@pytest.mark.parametrize("what,dtype,xshape,bshape,contig,ch,exc,match",
                         HEAD_GUARDS, ids=[g[0] for g in HEAD_GUARDS])
def test_head_older_guards_raise(what, dtype, xshape, bshape, contig, ch,
                                 exc, match):
    """The older head's wrapper raises on the same inputs."""
    x = _FakeCuda(torch.zeros(xshape, dtype=dtype))
    bank = _FakeCuda(torch.zeros(bshape, dtype=dtype), contig)
    bn_p, bn_s = _torch_bn()
    block = ResidualBlock(1, ch, first=True).eval()
    with pytest.raises(exc, match=match):
        fh.fused_frontend_head_older(x, bank, bn_p, bn_s, block)


def test_new_head_takes_at_most_24_rows():
    """The new kernel's frame tile holds 24 pooled rows (75 filters are 25):
    its wrapper refuses more, the older one's does not stop there."""
    x = _FakeCuda(torch.zeros((2, 1000), dtype=torch.bfloat16))
    bank = _FakeCuda(torch.zeros((75, 129), dtype=torch.bfloat16))
    bn_p, bn_s = _torch_bn()
    block = ResidualBlock(1, C, first=True).eval()
    with pytest.raises(ValueError, match="unsupported shape"):
        fh.fused_frontend_head(x, bank, bn_p, bn_s, block)
    with pytest.raises(TypeError, match="BatchNorm tensors"):
        fh.fused_frontend_head_older(x, bank, bn_p, bn_s, block)


class _Built(Exception):
    """Raised in place of the build: every check before it passed."""


def _stand_in_checks(monkeypatch, seen):
    """Stand in for the checks that need tensors on a card, and for the
    build, which records (source, definitions) and raises ``_Built``."""
    import types

    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import fused_frontend as fe

    def check_args(name, x, bank, bn_p, bn_s, dtypes=None, max_rows=None):
        return x.shape[0], x.shape[1], bank.shape[0], None

    def fold_block0(block):
        return types.SimpleNamespace(
            w1=_FakeCuda(block.conv1.weight.detach()))

    def load(src, defines=None):
        seen.append((src, defines))
        raise _Built
    monkeypatch.setattr(fe, "check_args", check_args)
    monkeypatch.setattr(fh.fs, "fold_block0", fold_block0)
    monkeypatch.setattr(_build, "load", load)


@pytest.mark.parametrize("name,source", [
    ("fused_frontend_head", "frontend_head_pipe"),
    ("fused_frontend_head_older", "frontend_head")])
def test_head_wrappers_launch_their_builds(monkeypatch, name, source):
    """``fused_frontend_head`` asks for ``csrc/frontend_head_pipe.cu``'s
    plain build and ``fused_frontend_head_older`` for
    ``csrc/frontend_head.cu``'s, and neither counts a launch when it stops
    there."""
    seen = []
    _stand_in_checks(monkeypatch, seen)
    x = _FakeCuda(torch.zeros((2, 1000), dtype=torch.bfloat16))
    bank = _FakeCuda(torch.zeros((70, 129), dtype=torch.bfloat16))
    bn_p, bn_s = _torch_bn()
    fn = getattr(fh, name)
    before = fn.launches
    with pytest.raises(_Built):
        fn(x, bank, bn_p, bn_s, ResidualBlock(1, C, first=True).eval())
    assert seen == [(source, None)] and fn.launches == before


@pytest.mark.parametrize("name,source", [
    ("fused_frontend_dot_fm", "frontend_dot_wg"),
    ("fused_frontend_dot_bm", "frontend_dot_wg"),
    ("fused_frontend_dot_fm_older", "frontend_dot"),
    ("fused_frontend_dot_bm_older", "frontend_dot"),
    ("fused_frontend_dot_plain", "frontend_dot"),
    ("fused_frontend_dot_padded", "frontend_dot")])
def test_dot_wrappers_launch_their_builds(monkeypatch, name, source):
    """``fused_frontend_dot_{fm,bm}`` ask for ``csrc/frontend_dot_wg.cu``;
    their ``_older`` twins and the Scorer's routes,
    ``fused_frontend_dot_{plain,padded}``, for ``csrc/frontend_dot.cu``;
    none counts a launch when the build stops it.  ``_launch`` refuses a
    source or layout it does not know."""
    seen = []
    _stand_in_checks(monkeypatch, seen)
    x = _FakeCuda(torch.zeros((2, 1000), dtype=torch.bfloat16))
    bank = _FakeCuda(torch.zeros((70, 129), dtype=torch.bfloat16))
    bn_p, bn_s = _torch_bn()
    fn = getattr(fv, name)
    before = fn.launches
    with pytest.raises(_Built):
        fn(x, bank, bn_p, bn_s)
    assert seen == [(source, None)] and fn.launches == before
    assert source in (fv.SOURCE, fv.OLDER_SOURCE)
    with pytest.raises(ValueError, match="unknown source"):
        fv._launch(name, x, bank, bn_p, bn_s, "fm", "frontend_head")
    with pytest.raises(ValueError, match="unknown source"):
        fv._launch(name, x, bank, bn_p, bn_s, "nchw", source)


def test_dot_probe_builds_are_the_sources_variants(monkeypatch):
    """Every build the frontend probe (``aasist_tpu_torch/tools/
    probe_frontend_variants.py``) times is ``csrc/frontend_dot_wg.cu`` with
    definitions its header names, and ``_launch`` asks for exactly that
    build; the default first and the only one checked, then the
    timing-only cuts."""
    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.tools import probe_frontend_variants as pfv

    builds = pfv.builds()
    assert list(builds) == ["base", "one_window", "no_store",
                            "one_window_no_store"]
    assert builds["base"] == (fv.SOURCE, None)
    assert [n for n, (_, checked) in pfv.WG_BUILDS.items() if checked] == [
        "base"]
    assert [d for d, _ in list(pfv.WG_BUILDS.values())[1:]] == [
        {"FDW_CUT": 1}, {"FDW_CUT": 2}, {"FDW_CUT": 3}]
    header = (_build.CSRC / f"{fv.SOURCE}.cu").read_text()
    for _, defines in builds.values():
        for name in defines or ():
            assert f"#ifdef {name}" in header or f"#ifndef {name}" in header
    seen = []
    _stand_in_checks(monkeypatch, seen)
    x = _FakeCuda(torch.zeros((2, 1000), dtype=torch.bfloat16))
    bank = _FakeCuda(torch.zeros((70, 129), dtype=torch.bfloat16))
    bn_p, bn_s = _torch_bn()
    for src, defines in builds.values():
        with pytest.raises(_Built):
            fv._launch("probe", x, bank, bn_p, bn_s, "fm", src, defines)
    assert seen == list(builds.values())


def test_head_probe_builds_are_the_sources_variants(monkeypatch):
    """Every build of the head probe (``aasist_tpu_torch/tools/
    probe_feb0_ablate.py``) is one of the two sources with its definitions,
    and ``launch`` asks for exactly that build: six of each, the new
    source's tile widths half and a quarter of its default's (twice does
    not fit in shared memory), the older one's half and twice."""
    from aasist_tpu_torch.tools import probe_feb0_ablate as pfa

    builds = pfa.builds()
    assert {src for src, _ in builds.values()} == {fh.SOURCE,
                                                   fh.OLDER_SOURCE}
    assert builds["base"] == (fh.SOURCE, None)
    assert builds["base older"] == (fh.OLDER_SOURCE, None)
    assert builds["half"] == (fh.SOURCE, {"HEADP_SUB": 4})
    assert builds["quarter"] == (fh.SOURCE, {"HEADP_SUB": 2})
    assert "double" not in builds and "quarter older" not in builds
    assert builds["double older"] == (fh.OLDER_SOURCE, {"HEAD_WARPS_T": 4})
    assert len(builds) == 12
    seen = []
    _stand_in_checks(monkeypatch, seen)
    x = _FakeCuda(torch.zeros((2, 1000), dtype=torch.bfloat16))
    bank = _FakeCuda(torch.zeros((70, 129), dtype=torch.bfloat16))
    bn_p, bn_s = _torch_bn()
    block = ResidualBlock(1, C, first=True).eval()
    for src, defines in builds.values():
        with pytest.raises(_Built):
            fh.launch(x, bank, bn_p, bn_s, block, defines, src)
    assert seen == list(builds.values())
    assert [n for n, (src, _) in builds.items() if src == fh.SOURCE] == [
        "base", "noselu", "bf16acc", "nodot", "half", "quarter"]
    with pytest.raises(ValueError, match="unknown source"):
        fh.launch(x, bank, bn_p, bn_s, block, source="frontend_dot")


def test_head_needs_block0():
    x, bank, bn_p, bn_s = _cpu_args()
    with pytest.raises(ValueError, match="downsample"):
        fh.fused_frontend_head(x, bank, bn_p, bn_s,
                               ResidualBlock(8, 8, first=False))


def test_build_hashes_the_definitions(tmp_path, monkeypatch):
    """``_build.load`` names a variant's library by its definitions too, so
    a probe's variant never reuses the base build."""
    from aasist_tpu_torch.ops import _build

    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        raise RuntimeError("stop before nvcc")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    for defines in (None, {"HEAD_NOSELU": None}, {"HEAD_WARPS_T": 4}):
        with pytest.raises(RuntimeError, match="stop before nvcc"):
            _build.load("frontend_head", defines)
    outs = [cmd[cmd.index("-o") + 1] for cmd in calls]
    assert len(set(outs)) == 3
    assert "-DHEAD_NOSELU" in calls[1] and "-DHEAD_WARPS_T=4" in calls[2]
    assert not any(a.startswith("-D") for a in calls[0])
