"""The plain versions of the block-0 variants
(``aasist_tpu_torch/ops/block0_variants``) against the JAX probes' kernels,
on the CPU.

``tools/probe_b0_constructs.py``, ``probe_b0_ablate.py`` and
``probe_b0_epi.py`` call ``pl.pallas_call`` without ``interpret``; the tests
patch ``pl.pallas_call`` to interpret mode before the first call, with
nothing in ``tools/`` changed.  The probes read ``zt``, mod-3 phase planes of
z cut into overlapping tiles: ``_zt`` builds it from z as
``tools/fused_stack.py:fused_frontend_block0`` does, and the port gets the
same z inside its zero-bordered frame.  z, the weights and the BatchNorm
statistics come from numpy seeds.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from aasist_tpu.models.layers import sinc_filterbank

from aasist_tpu_torch.models.layers import ResidualBlock
from aasist_tpu_torch.ops import block0_pipe as bp
from aasist_tpu_torch.ops import block0_variants as bv
from aasist_tpu_torch.ops import fused_stack as fs
from aasist_tpu_torch.tools import _common
from aasist_tpu_torch.weights import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools"))
import fused_stack as FS  # noqa: E402
import probe_b0_ablate as PBA  # noqa: E402
import probe_b0_constructs as PBC  # noqa: E402
import probe_b0_epi as PBE  # noqa: E402

C, F_Z, U = 32, 23, 128
FE_P = {"weight": np.asarray([1.3], np.float32),
        "bias": np.asarray([0.2], np.float32)}
FE_S = {"mean": np.asarray([0.1], np.float32),
        "var": np.asarray([1.5], np.float32)}


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


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


def _z(seed, b, t_z):
    """A frontend-like z (B, 23, T_z): SELU's range, rounded to bf16 so that
    the f32 and the bf16 cases read the same values."""
    z = np.random.default_rng(seed).normal(0, 1, (b, F_Z, t_z))
    z = np.where(z > 0, 1.05 * z, 1.76 * (np.exp(z) - 1))
    return torch.from_numpy(z.astype(np.float32)).bfloat16().float().numpy()


def _zt(z, u=U):
    """z (B, 23, T_z) -> (zt (n_tiles, B, 104, u + 4), T_z // 3), the
    block-0 kernel's input as ``tools/fused_stack.py:447-458`` builds it from
    the frontend kernel's phase planes: rows q * 32 + 1 + f hold
    z[:, f, q::3], two columns of left halo, rows padded to 104."""
    b, _, t_z = z.shape
    v_z, t_out = -(-t_z // 3), t_z // 3
    planes = np.zeros((b, 96, v_z), np.float32)
    for q in range(3):
        n_q = -(-(t_z - q) // 3)
        planes[:, q * 32 + 1:q * 32 + 1 + F_Z, :n_q] = z[:, :, q::3]
    nt2 = -(-t_out // u)
    need = nt2 * u + 2
    zb = np.pad(planes, ((0, 0), (0, 8), (2, max(0, need - v_z))))
    return (np.stack([zb[:, :, j * u:j * u + u + 4] for j in range(nt2)]),
            t_out)


def _both(seed, b, t_z, dtype):
    """(JAX args up to t_z, T_out, the port's frame, the port's block)."""
    p, s = _block0_params(seed)
    z = _z(seed + 1, b, t_z)
    zt, t_out = _zt(z)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    fsp = FS.FusedStackParams(sinc_filterbank(70, 129, 16000), FE_P, FE_S,
                              p, s, dtype=jdt)
    jargs = (jnp.asarray(zt, jdt), fsp.w1, fsp.sb1, fsp.w0, fsp.wm1,
             fsp.wp1, fsp.b2, 1, U, C, t_z)
    frame = torch.nn.functional.pad(torch.from_numpy(z),
                                    (1, 1, 1, 1)).to(dtype)
    block = load_jax_params(ResidualBlock(1, C, first=True), p, s).eval()
    return jargs, t_out, frame, block.to(dtype)


def _rel_err(got, ref, t_out):
    ref = np.asarray(ref, np.float32)[:, :, :, :t_out]
    got = got.float().numpy()
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


CONSTRUCTS = {"none": (False, False, False), "bf16epi": (True, False, False),
              "rmw": (False, True, False), "b2slice": (False, False, True),
              "all": (True, True, True)}
# bf16 frames against the JAX kernels in bf16 (``probe_b0_constructs`` and
# ``probe_b0_epi`` cast to bf16 by name, so they run in no other type).  The
# port's kernel keeps the folded conv1 and downsample taps in f32 where the
# TPU kernel rounds them to bf16 (2^-9 relative on each of 6 taps), and the
# TPU kernel also rounds the downsample rows to bf16; conv2 then sums 192
# such y1 values: an ulp or two of the largest outputs (one ulp there is 2^-8
# to 2^-7 of max|ref|), 1.5e-2 of max|ref| (measured 4.8e-3 to 5.5e-3).
# In f32 the same plain arithmetic is held to 5e-5 by the stage tests below
# and by ``test_full_variants_are_block0``.
TOL_BF16 = 1.5e-2


@pytest.mark.parametrize("name", list(CONSTRUCTS))
def test_constructs_match_jax(interpret_pallas, name):
    flags = CONSTRUCTS[name]
    jargs, t_out, frame, block = _both(10, 2, 700, torch.bfloat16)
    ref = PBC.run(*jargs, *flags)
    with torch.inference_mode():
        got = bv.fused_block0_constructs(frame, block, *flags)
    assert got.dtype == torch.bfloat16
    err = _rel_err(got, ref, t_out)
    assert err < TOL_BF16, f"rel err {err:.2e}"


@pytest.mark.parametrize("stage", bv.STAGES)
def test_stages_match_jax(interpret_pallas, stage):
    """Every stage's plain version against the JAX stage kernel, f32, 5e-5
    of max|ref|."""
    assert tuple(PBA.STAGES) == bv.STAGES
    jargs, t_out, frame, block = _both(20, 2, 700, torch.float32)
    ref = PBA.run(*jargs, stage)
    with torch.inference_mode():
        got = bv.fused_block0_stage(frame, block, stage)
    if stage in ("dma", "fill"):
        assert bool((got[:, 1:] == 0).all())
        assert np.all(np.asarray(ref)[:, 1:] == 0)
    err = _rel_err(got, ref, t_out)
    assert err < 5e-5, f"rel err {err:.2e}"


def test_conv1_stage_is_not_masked_at_the_left_edge():
    """The conv1 stage's first pooled column sums times -3, -2, -1, where
    conv1 and the downsample read only zeros and z[0]: three shifts and
    three biases plus the taps that reach z[:, :, 0]."""
    _, _, frame, block = _both(20, 1, 40, torch.float32)
    prm = fs.fold_block0(block)
    bd = block.conv_downsample.bias.detach()
    with torch.inference_mode():
        got = bv.fused_block0_stage(frame, block, "conv1")[0, :, :, 0]
    z0 = frame[0, :, 1]                                   # frame rows 0..24
    want = (3 * prm.shift1[:, None] + 3 * bd[:, None]
            + prm.w1[:, 2, None] * z0[None, 0:23]
            + prm.w1[:, 5, None] * z0[None, 1:24]
            + prm.wd[:, 2, None] * z0[None, 1:24])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_ladder(variant):
    """The JAX ladder kernel's output on the ladder tests' input (call it
    under ``interpret_pallas``; kept for the tests that share it)."""
    jargs, t_out, _, _ = _both(30, 2, 700, torch.bfloat16)
    return np.asarray(PBE.run(*jargs, variant), np.float32)[:, :, :, :t_out]


@pytest.mark.parametrize("variant", bv.EPI_VARIANTS)
def test_cast_ladder_matches_jax(interpret_pallas, variant):
    _, t_out, frame, block = _both(30, 2, 700, torch.bfloat16)
    ref = _jax_ladder(variant)
    with torch.inference_mode():
        got = bv.fused_block0_epi(frame, block, variant)
    assert got.dtype == torch.bfloat16
    err = _rel_err(got, ref, t_out)
    assert err < TOL_BF16, f"rel err {err:.2e}"


@pytest.mark.parametrize("variant", ["base", "vA", "vF"])
def test_cast_ladder_nearest_is_its_own_cast_point(interpret_pallas, variant):
    """``TOL_BF16`` is on the largest error, an ulp or two whatever the cast
    point.  In the mean each JAX variant is nearer to the port's variant of
    the same name than to those that round elsewhere (measured: 2.9e-3 to
    3.5e-3 of mean|ref| for its own, 3.6e-3 to 4.6e-3 for the others)."""
    _, _, frame, block = _both(30, 2, 700, torch.bfloat16)
    ref = _jax_ladder(variant)
    with torch.inference_mode():
        dist = {v: np.abs(bv.fused_block0_epi(frame, block, v).float()
                          .numpy() - ref).mean()
                for v in ("base", "vA", "vF")}
    assert min(dist, key=dist.get) == variant, dist


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_cast_ladder_values(dtype):
    """``base``, ``vB`` and ``vD`` are equal bit for bit (the halo mask is
    0 / 1); ``vA`` is the ``bf16epi`` construct; ``vA`` and ``vF`` differ
    from ``base`` (they round earlier) but stay within the ladder's
    tolerance of it."""
    _, _, frame, block = _both(40, 2, 500, dtype)
    with torch.inference_mode():
        out = {v: bv.fused_block0_epi(frame, block, v)
               for v in bv.EPI_VARIANTS}
        epi = bv.fused_block0_constructs(frame, block, bf16epi=True)
    for v in ("vB", "vD"):
        torch.testing.assert_close(out[v], out["base"], rtol=0, atol=0)
    torch.testing.assert_close(epi, out["vA"], rtol=0, atol=0)
    top = out["base"].float().abs().max()
    for v in ("vA", "vF"):
        d = (out[v].float() - out["base"].float()).abs().max() / top
        assert 0 < d < TOL_BF16, f"{v}: {d:.2e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_full_variants_are_block0(dtype):
    """Stage ``full`` is ``fused_block0``; the plain ``base`` (the kernel's
    arithmetic: folded conv1, one y1 rounding) is the block's own chain to
    5e-5 of its maximum in f32 and 2e-2 in bf16 (the chain rounds six
    times)."""
    _, _, frame, block = _both(50, 3, 301, dtype)
    with torch.inference_mode():
        ref = fs.fused_block0(frame, block)
        full = bv.fused_block0_stage(frame, block, "full")
        base = bv.fused_block0_epi(frame, block, "base")
        none = bv.fused_block0_constructs(frame, block)
    torch.testing.assert_close(full, ref, rtol=0, atol=0)
    torch.testing.assert_close(none, base, rtol=0, atol=0)
    err = ((base.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert err < (5e-5 if dtype == torch.float32 else 2e-2), f"{err:.2e}"


def test_dense_only_lacks_exactly_the_off_split_taps():
    """Stage ``conv2`` equals ``full`` for a conv2 whose time taps 0 and 2
    are zero, and differs from it otherwise."""
    _, _, frame, block = _both(60, 2, 200, torch.float32)
    with torch.inference_mode():
        full = bv.fused_block0_epi(frame, block, "base")
        dense = bv.fused_block0_stage(frame, block, "conv2")
        assert (full - dense).abs().max() > 1e-2
        block.conv2.weight[:, :, :, 0] = 0
        block.conv2.weight[:, :, :, 2] = 0
        full = bv.fused_block0_epi(frame, block, "base")
        dense = bv.fused_block0_stage(frame, block, "conv2")
    torch.testing.assert_close(dense, full, atol=1e-5, rtol=1e-5)


CALLS = {
    "fused_block0_constructs": (True, True, True),
    "fused_block0_stage": ("epi",),
    "fused_block0_epi": ("vF",),
    "fused_block0_constructs_older": (True, True, True),
    "fused_block0_epi_older": ("vF",),
    "fused_block0_stage_older": ("epi",),
}
CUT_WRAPPERS = ("fused_block0_cut", "fused_block0_cut_older")


@pytest.mark.parametrize("name", list(CALLS))
def test_cpu_tensors_take_the_plain_versions(name):
    """A CPU tensor is no kernel launch and equals the plain version (the
    older kernel's builds share the new ones'); a device that is neither
    CPU nor CUDA raises."""
    _, _, frame, block = _both(70, 2, 100, torch.float32)
    fn = getattr(bv, name)
    ref_fn = getattr(bv, name.replace("_older", "") + "_reference")
    before = fn.launches
    with torch.inference_mode():
        torch.testing.assert_close(fn(frame, block, *CALLS[name]),
                                   ref_fn(frame, block, *CALLS[name]),
                                   rtol=0, atol=0)
    assert fn.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fn(frame.to("meta"), block, *CALLS[name])


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


@pytest.mark.parametrize("name", list(CALLS))
def test_cuda_call_without_a_card_raises(name):
    """With no card a frame cannot be moved to ``cuda``, and a call whose
    frame claims to be there and passes every guard raises before any result
    comes back, with no launch counted."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frame = torch.zeros((2, 25, 102), dtype=torch.bfloat16)
    block = ResidualBlock(1, C, first=True).eval()
    fn = getattr(bv, name)
    with pytest.raises((RuntimeError, AssertionError)):
        fn(frame.to("cuda"), block, *CALLS[name])
    before = fn.launches
    with pytest.raises((RuntimeError, TypeError)):
        fn(_FakeCuda(frame), block, *CALLS[name])
    assert fn.launches == before


GUARDS = [
    ("a float32 frame", torch.float32, (2, 25, 102), True, C, TypeError,
     "not supported .bfloat16."),
    ("a 4-D frame", torch.bfloat16, (2, 1, 25, 102), True, C, ValueError,
     "contiguous"),
    ("a strided frame", torch.bfloat16, (2, 25, 102), False, C, ValueError,
     "contiguous"),
    ("fewer than 3 columns", torch.bfloat16, (2, 25, 4), True, C, ValueError,
     "unsupported frame"),
    ("a block of 8 channels", torch.bfloat16, (2, 25, 102), True, 8,
     ValueError, "takes 32 channels"),
]


@pytest.mark.parametrize("what,dtype,shape,contig,ch,exc,match", GUARDS,
                         ids=[g[0] for g in GUARDS])
@pytest.mark.parametrize("name", list(CALLS))
def test_guards_raise(name, what, dtype, shape, contig, ch, exc, match):
    frame = _FakeCuda(torch.zeros(shape, dtype=dtype), contig)
    block = ResidualBlock(1, ch, first=True).eval()
    with pytest.raises(exc, match=match):
        getattr(bv, name)(frame, block, *CALLS[name])


@pytest.mark.parametrize("name,args,match", [
    ("fused_block0_stage", ("mma",), "not one of"),
    ("fused_block0_epi", ("vC",), "not one of"),
    ("fused_block0_stage_reference", ("mma",), "not one of"),
    ("fused_block0_epi_reference", ("vC",), "not one of"),
])
def test_unknown_variant_raises(name, args, match):
    frame = torch.zeros((1, 25, 32))
    block = ResidualBlock(1, C, first=True).eval()
    with pytest.raises(ValueError, match=match):
        getattr(bv, name)(frame, block, *args)


@pytest.mark.parametrize("name", list(CALLS))
def test_variants_need_block0(name):
    with pytest.raises(ValueError, match="downsample"):
        getattr(bv, name)(torch.zeros((1, 25, 32)),
                          ResidualBlock(8, 8, first=False), *CALLS[name])


def test_defines_name_thirteen_builds():
    """The constructs, the stages and the cast ladder are builds of
    ``csrc/block0_pipe.cu``, their ``_older`` wrappers the same definitions
    on ``csrc/fused_block0.cu``.  The default build serves ``none``,
    ``base`` and ``full``; every other variant has definitions of its own,
    and ``vA`` shares ``bf16epi``'s: thirteen builds of each source."""
    new = [bv.constructs_build(*f) for f in CONSTRUCTS.values()]
    new += [bv.stage_build(s) for s in bv.STAGES]
    new += [bv.epi_build(v) for v in bv.EPI_VARIANTS]
    older = [bv.constructs_build(*f, older=True) for f in CONSTRUCTS.values()]
    older += [bv.stage_build(s, older=True) for s in bv.STAGES]
    older += [bv.epi_build(v, older=True) for v in bv.EPI_VARIANTS]
    assert {src for src, _ in new} == {"block0_pipe"}
    assert {src for src, _ in older} == {"fused_block0"}
    assert [d for _, d in new] == [d for _, d in older]
    assert [d for _, d in new[5:11]] == [
        {"B0_STAGE": k} for k in range(5)] + [None]
    assert bv.constructs_defines(False, False, False) is None
    assert bv.stage_defines("full") is None and bv.epi_defines("base") is None
    assert bv.epi_defines("vA") == bv.constructs_defines(True, False, False)
    assert bv.constructs_build(True, True, True)[1] == {
        "B0_EPI": 1, "B0_RMW": None, "B0_B2SLICE": None}
    assert [bv.epi_defines(v) for v in bv.EPI_VARIANTS] == [
        None, {"B0_EPI": 1}, {"B0_EPI": 2}, {"B0_EPI": 3}, {"B0_EPI": 4}]

    def count(builds):
        return len({(src, tuple(sorted((d or {}).items(), key=str)))
                    for src, d in builds})
    assert count(older) == 13 and count(new) == 13


class _Built(Exception):
    """Raised in place of the build: every check before it passed."""


@pytest.mark.parametrize("name", [n for n in CALLS if "stage" not in n]
                         + [n for n in CALLS if "stage" in n]
                         + list(CUT_WRAPPERS))
def test_wrappers_launch_their_builds(monkeypatch, name):
    """Each wrapper asks for the build ``constructs_build`` /
    ``stage_build`` / ``epi_build`` / ``cut_build`` names, and counts
    nothing when it stops there.  (``check_frame`` is stood in for: a frame
    on a card cannot be made here.)"""
    from aasist_tpu_torch.ops import _build
    _, _, frame, block = _both(71, 1, 100, torch.bfloat16)
    family = next(f for f in ("constructs", "stage", "epi", "cut")
                  if f"_{f}" in name)
    cases = {"constructs": CONSTRUCTS,
             "stage": {s: (s,) for s in bv.STAGES},
             "epi": {v: (v,) for v in bv.EPI_VARIANTS},
             "cut": {c: (c,) for c in bv.CUTS}}[family]
    build = {"constructs": bv.constructs_build, "stage": bv.stage_build,
             "epi": bv.epi_build, "cut": bv.cut_build}[family]
    seen = []

    def check_frame(n, z, blk, dtypes):
        assert dtypes == (torch.bfloat16,) and n == name
        return (1, 23, 98, C, fs.fold_block0(blk))

    def load(src, defines=None):
        seen.append((src, defines))
        raise _Built
    monkeypatch.setattr(fs, "check_frame", check_frame)
    monkeypatch.setattr(_build, "load", load)
    fn = getattr(bv, name)
    before = fn.launches
    for args in cases.values():
        with pytest.raises(_Built):
            fn(_FakeCuda(frame), block, *args)
    older = name.endswith("_older")
    want = [build(*a, older=older) for a in cases.values()]
    assert {src for src, _ in seen} == {
        "fused_block0" if older else "block0_pipe"}
    assert seen == want and fn.launches == before


def test_variant_bias_rows():
    """The variant builds' bias: conv2's plus the downsample's, the
    downsample's, conv2's."""
    _, _, _, block = _both(72, 1, 100, torch.float32)
    b2, bd = block.conv2.bias.detach(), block.conv_downsample.bias.detach()
    got = bv.variant_bias(block)
    assert tuple(got.shape) == (3, C) and got.is_contiguous()
    torch.testing.assert_close(got, torch.stack([b2 + bd, bd, b2]),
                               rtol=0, atol=0)


def test_cut_builds_are_timing_only():
    """``fused_block0_cut`` has no plain version: a CPU frame raises, as
    does an unknown cut, and nothing is counted.  Each source numbers the
    phases its own way (their headers): ``block0_pipe.cu`` keeps the bits
    1 (no y1) and 2 (no MMA loop) of its timing cuts and adds 4 (no frame
    tile issued) and 8 (no store); ``only_loop`` is all four on both."""
    _, _, frame, block = _both(70, 1, 100, torch.bfloat16)
    before = bv.fused_block0_cut.launches
    with pytest.raises(ValueError, match="unsupported device"):
        bv.fused_block0_cut(frame, block, "no_mma")
    with pytest.raises(ValueError, match="not one of"):
        bv.fused_block0_cut(frame, block, "no_pool")
    assert bv.fused_block0_cut.launches == before
    assert [bv.cut_defines(c, older=True) for c in bv.CUTS] == [
        {"B0_CUT": bits} for bits in (1, 2, 4, 8, 15)]
    assert [bv.cut_defines(c) for c in bv.CUTS] == [
        {"B0P_CUT": bits} for bits in (4, 1, 2, 8, 15)]
    pipe = bv.CUT_BITS[bv.PIPE_SOURCE][1]
    assert pipe["no_conv1"] == bp.PIPE_CUTS["no_conv1"]
    assert pipe["no_mma"] == bp.PIPE_CUTS["no_mma"]
    for src in (bv.PIPE_SOURCE, bv.OLDER_SOURCE):
        bits = bv.CUT_BITS[src][1]
        assert bits["only_loop"] == sum(
            bits[c] for c in bv.CUTS if c != "only_loop")


def test_older_cut_builds_are_timing_only():
    """``fused_block0_cut_older`` likewise: no plain version, a CPU frame
    and an unknown cut raise, nothing is counted."""
    _, _, frame, block = _both(70, 1, 100, torch.bfloat16)
    before = bv.fused_block0_cut_older.launches
    with pytest.raises(ValueError, match="unsupported device"):
        bv.fused_block0_cut_older(frame, block, "no_load")
    with pytest.raises(ValueError, match="not one of"):
        bv.fused_block0_cut_older(frame, block, "no_pool")
    assert bv.fused_block0_cut_older.launches == before


@pytest.mark.parametrize("name", CUT_WRAPPERS)
def test_cut_cuda_call_without_a_card_raises(name):
    """With no card a cut's frame cannot be moved to ``cuda``, and a frame
    that claims to be there raises before any result, nothing counted."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frame = torch.zeros((2, 25, 102), dtype=torch.bfloat16)
    block = ResidualBlock(1, C, first=True).eval()
    fn = getattr(bv, name)
    with pytest.raises((RuntimeError, AssertionError)):
        fn(frame.to("cuda"), block, "no_epi")
    before = fn.launches
    with pytest.raises((RuntimeError, TypeError)):
        fn(_FakeCuda(frame), block, "no_epi")
    assert fn.launches == before


# The gates the card's checks apply (tools/_common.py:b0_readings), shown
# on the plain versions to tell what they are there to tell.
@pytest.mark.parametrize("variant", _common.B0_BF16_EPILOGUES[2:])
def test_readings_tell_the_cast_point(variant):
    """An output with the f32 epilogue's values held against a bf16
    epilogue's plain version is farther from it than from ``base``'s, and
    is refused; the variant's own values pass."""
    _, _, frame, block = _both(80, 2, 700, torch.bfloat16)
    with torch.inference_mode():
        own = bv.fused_block0_epi_reference(frame, block, variant)
        base = bv.fused_block0_epi_reference(frame, block, "base")
        bad = bv.fused_block0_epi_reference(
            *_common.b0_fault(variant, frame, block), variant)
    assert _common.b0_readings(variant, own, own, bad, base)[1] == []
    fails = _common.b0_readings(variant, base, own, bad, base)[1]
    assert any("no nearer" in f for f in fails), fails
    fails = _common.b0_readings(variant, own, own, own, base)[1]
    assert any("planted fault" in f for f in fails), fails


@pytest.mark.parametrize("stage", _common.B0_CHECKED_STAGES)
def test_readings_tell_the_planted_stage_fault(stage):
    """The stage's output under its planted fault fails the gates that the
    sound output passes, and reads as a told fault."""
    _, _, frame, block = _both(90, 2, 700, torch.bfloat16)
    with torch.inference_mode():
        plain = bv.fused_block0_stage_reference(frame, block, stage)
        bad = bv.fused_block0_stage_reference(
            *_common.b0_fault(stage, frame, block), stage)
    assert _common.b0_readings(stage, plain, plain, bad)[1] == []
    assert _common.b0_readings(stage, bad, plain, bad)[1] != []
    fails = _common.b0_readings(stage, plain, plain, plain)[1]
    assert any("planted fault" in f for f in fails), fails


def test_gates_by_variant_name():
    assert _common.b0_gate("rmw") == _common.b0_gate("full") == 2e-2
    assert _common.b0_gate("vF") == _common.b0_gate("all") == 5e-3
    assert _common.b0_gate("conv1") == 1e-2
    assert _common.b0_fault("vB", None, None) is None
    names = set(CONSTRUCTS) | set(bv.STAGES) | set(bv.EPI_VARIANTS)
    assert names == (set(_common.B0_SAME_VALUES)
                     | set(_common.B0_BF16_EPILOGUES)
                     | set(_common.B0_CHECKED_STAGES))


@pytest.mark.parametrize("stage,ms,by", [
    ("dma", 0.4439, "bytes"), ("fill", 0.4439, "bytes"),
    ("conv1", 0.4439, "bytes"), ("epi", 0.4439, "bytes"),
    ("conv2", 0.6493, "operations"), ("full", 0.8239, "operations")])
def test_stage_bounds(stage, ms, by):
    """A stage's bound counts what that stage must do at (128, 64600) in
    bfloat16 on the H100's data-sheet peaks: the frame read and the output
    written for the stages without conv2, 14 of conv2's 18 (phase, tap)
    pairs for ``conv2``; ``full`` is block 0's."""
    got = _common.stage_bound(stage, 128, 64600, C, "bfloat16")
    assert got[1] == by and abs(got[0] - ms) < 1e-4
    if stage == "full":
        assert got == _common.block0_bound(128, 64600, C, "bfloat16")
