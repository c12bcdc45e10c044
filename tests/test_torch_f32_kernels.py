"""The f32 kernels, on the CPU: the 3xTF32 frontend and the CUDA-core
frontend (``ops/frontend_f32.py``, plain and padded stores each) and the
3xTF32 block 0 (``ops/block0_f32.py``).

The split's arithmetic (``split_tf32``, hi and lo rounded to TF32, three
products summed in f32) emulated in plain PyTorch and held against the JAX
package's f32 functions at the card's gates: the frontend at (3, 16001)
against the Pallas frontend at ``TOL_F32`` (atol 1e-4), block 0 on a narrow
frame against the Pallas frontend + block-0 pair at 5e-5 of max.  This
shows before the card that the design's arithmetic clears the f32 gates.
Then the wrappers' plain routes against the JAX package, the kernels' work
decompositions, the routing by type, the guards and the launch counts.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from aasist_tpu.models.layers import sinc_filterbank
from aasist_tpu.ops.fused_frontend import fused_frontend as jax_fused_frontend

from aasist_tpu_torch.models.layers import ResidualBlock
from aasist_tpu_torch.ops import block0_f32 as b32
from aasist_tpu_torch.ops import frontend_f32 as f32
from aasist_tpu_torch.ops import fused_frontend as fe
from aasist_tpu_torch.ops import fused_stack as fs
from aasist_tpu_torch.weights import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools"))
import fused_stack as FS  # noqa: E402

C = 32
TOL_F32 = 1e-4           # chip_smoke.py:TOL_F32, the frontend's f32 gate
TOL_BLOCK0_F32 = 5e-5    # chip_smoke.py:TOL_BLOCK0["float32"], of max
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
    f = np.float32
    p = {
        "conv1": {"weight": r.normal(0, 0.3, (C, 1, 2, 3)).astype(f),
                  "bias": r.normal(0, 0.1, (C,)).astype(f)},
        "conv2": {"weight": r.normal(0, 0.2, (C, C, 2, 3)).astype(f),
                  "bias": r.normal(0, 0.1, (C,)).astype(f)},
        "conv_downsample": {
            "weight": r.normal(0, 0.3, (C, 1, 1, 3)).astype(f),
            "bias": r.normal(0, 0.1, (C,)).astype(f)},
        "bn2": {"weight": 1.0 + 0.1 * r.normal(0, 1, (C,)).astype(f),
                "bias": 0.1 * r.normal(0, 1, (C,)).astype(f)},
    }
    s = {"bn2": {"mean": 0.05 * r.normal(0, 1, (C,)).astype(f),
                 "var": (1.0 + 0.2 * r.random((C,))).astype(f)}}
    return p, s


def _block(seed=0):
    return load_jax_params(ResidualBlock(1, C, first=True),
                           *_block0_params(seed)).eval()


# ---------------------------------------------------------- the split
def test_split_tf32_rounds_to_nearest_ties_away():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (cvt.rna.tf32.f32); lo is the rest rounded the same way; hi + lo
    is x to 2^-22 relative."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 0.0, 3.0e-20], dtype=torch.float32)
    hi, lo = f32.split_tf32(x)
    assert hi.tolist()[:5] == [one + ulp, -(one + ulp), one, one + ulp, 0.0]
    bits = hi.view(torch.int32) & 0x1FFF
    assert not bits.any() and not (lo.view(torch.int32) & 0x1FFF).any()
    r = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, 100_000).astype(np.float32))
    h, lw = f32.split_tf32(r)
    err = ((h.double() + lw.double() - r.double()).abs() / r.double().abs())
    assert err.max().item() <= 2.0 ** -22
    assert (h.double() - r.double()).abs().max().item() > 1e-4


def test_tf32x3_products_are_near_f32_and_tf32_alone_is_not():
    """The emulated 3xTF32 conv against float64: within a few f32 ulps of
    the sums' scale, where one TF32 product (the control) is ~2^-11 off."""
    rng = np.random.default_rng(1)
    x = _t(rng.normal(0, 1, (2, 1, 4000)))
    w = _t(rng.normal(0, 0.1, (70, 1, 129)))
    ref = F.conv1d(x.double(), w.double())
    three = f32.conv1d_tf32x3(x, w).double()
    xh, wh = f32.split_tf32(x)[0], f32.split_tf32(w)[0]
    one = F.conv1d(xh, wh).double()
    scale = F.conv1d(x.double().abs(), w.double().abs()).max().item()
    e3 = (three - ref).abs().max().item() / scale
    e1 = (one - ref).abs().max().item() / scale
    assert e3 < 2e-6 and e1 > 100 * e3, (e3, e1)


@pytest.mark.parametrize("masked", [False, True])
def test_emulated_frontend_clears_the_f32_gate_against_jax(masked):
    """The kernel's 3xTF32 arithmetic on the frontend at (3, 16001) against
    the Pallas frontend (interpret mode) at TOL_F32."""
    rng = np.random.default_rng(30)
    x = (rng.standard_normal((3, 16001)) * 0.1).astype(np.float32)
    bank = sinc_filterbank(70, 129, 16000).astype(np.float32)
    if masked:
        bank[10:20] = 0
    ref = np.asarray(jax_fused_frontend(jnp.asarray(x), jnp.asarray(bank),
                                        FE_P, FE_S), np.float32)
    got = f32.frontend_tf32x3_emulated(_t(x), _t(bank), *_bn()).numpy()
    assert got.shape == ref.shape == (3, 1, 23, (16001 - 128) // 3)
    np.testing.assert_allclose(got, ref, atol=TOL_F32, rtol=0)


def test_emulated_block0_clears_the_f32_gate_against_jax():
    """The kernels' 3xTF32 arithmetic on the pair at a narrow frame (2 x
    2,400 samples, F = 23, T_z = 757) against the Pallas frontend + block-0
    pair at 5e-5 of max."""
    p, s = _block0_params(0)
    bank = sinc_filterbank(70, 129, 16000).astype(np.float32)
    b, length = 2, 2400
    x = np.random.default_rng(1).normal(0, 1, (b, length)).astype(np.float32)
    fsp = FS.FusedStackParams(bank, FE_P, FE_S, p, s, dtype=jnp.float32)
    ref = np.asarray(FS.fused_frontend_block0(jnp.asarray(x), fsp),
                     np.float32)
    block = load_jax_params(ResidualBlock(1, C, first=True), p, s).eval()
    with torch.inference_mode():
        z = F.pad(f32.frontend_tf32x3_emulated(_t(x), _t(bank), *_bn())[:, 0],
                  (1, 1, 1, 1))
        got = b32.block0_tf32x3_emulated(z, block).numpy()
    assert got.shape == ref.shape == (b, C, 23, (length - 128) // 9)
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < TOL_BLOCK0_F32, f"rel err {err:.2e}"


# ------------------------------------------------- the plain routes
@pytest.mark.parametrize("b,length,masked", [(2, 2400, False),
                                             (3, 4000, True)])
def test_frontend_wrappers_plain_routes_match_jax(b, length, masked):
    """On CPU tensors both stores are the plain version: against the Pallas
    frontend at TOL_F32, the frame's border exactly zero."""
    rng = np.random.default_rng(40 + b)
    x = (rng.standard_normal((b, length)) * 0.1).astype(np.float32)
    bank = sinc_filterbank(70, 129, 16000).astype(np.float32)
    if masked:
        bank[10:20] = 0
    ref = np.asarray(jax_fused_frontend(jnp.asarray(x), jnp.asarray(bank),
                                        FE_P, FE_S), np.float32)
    for kind in ("tf32x3", "ffma"):
        plain = getattr(f32, f"fused_frontend_{kind}")(
            _t(x), _t(bank), *_bn()).numpy()
        padded = getattr(f32, f"fused_frontend_padded_{kind}")(
            _t(x), _t(bank), *_bn()).numpy()
        np.testing.assert_allclose(plain, ref, atol=TOL_F32, rtol=0)
        np.testing.assert_allclose(padded[:, 1:-1, 1:-1], ref[:, 0],
                                   atol=TOL_F32, rtol=0)
        assert not padded[:, [0, -1]].any()
        assert not padded[:, :, [0, -1]].any()


def test_block0_wrapper_plain_route_matches_jax():
    p, s = _block0_params(2)
    bank = sinc_filterbank(70, 129, 16000).astype(np.float32)
    x = np.random.default_rng(3).normal(0, 1, (2, 2400)).astype(np.float32)
    fsp = FS.FusedStackParams(bank, FE_P, FE_S, p, s, dtype=jnp.float32)
    ref = np.asarray(FS.fused_frontend_block0(jnp.asarray(x), fsp),
                     np.float32)
    block = load_jax_params(ResidualBlock(1, C, first=True), p, s).eval()
    with torch.inference_mode():
        z = f32.fused_frontend_padded_tf32x3(_t(x), _t(bank), *_bn())
        got = b32.block0_tf32x3(z, block).numpy()
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < TOL_BLOCK0_F32, f"rel err {err:.2e}"


# ------------------------------------------------ work decompositions
def _cover(items, shape):
    seen = np.zeros(shape, np.int32)
    for b, f0, f1, t0, t1 in items:
        assert 0 <= f0 < f1 <= shape[1] and 0 <= t0 < t1 <= shape[2]
        seen[b, f0:f1, t0:t1] += 1
    return seen


@pytest.mark.parametrize("b,f,t_out", [(128, 23, 7163), (3, 23, 1763),
                                       (2, 30, 40)],
                         ids=["main path", "ragged L=16001", "four bands"])
def test_block0_f32_work_covers_each_output_once(b, f, t_out):
    n_tiles, n_bands, n_work = b32.f32_work(b, f, t_out)
    assert n_tiles == -(-t_out // 16) and n_bands == -(-f // 8)
    assert n_work == b * n_bands * n_tiles
    assert (_cover(b32.f32_items(b, f, t_out), (b, f, t_out)) == 1).all()


@pytest.mark.parametrize("b,length", [(128, 64600), (3, 16001)])
def test_frontend_f32_work_covers_each_output_once(b, length):
    t_out = (length - 128) // 3
    n_tiles, n_work = f32.f32_work(b, length)
    assert n_tiles == -(-t_out // f32.F32_TILE) and n_work == b * n_tiles
    items = []
    for w in range(n_work):
        t0 = (w % n_tiles) * f32.F32_TILE
        items.append((w // n_tiles, 0, 1, t0, min(t0 + f32.F32_TILE, t_out)))
    assert (_cover(items, (b, 1, t_out)) == 1).all()


# ------------------------------------------- routes, counts, guards
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


WRAPPERS = (f32.fused_frontend_tf32x3, f32.fused_frontend_padded_tf32x3,
            f32.fused_frontend_ffma, f32.fused_frontend_padded_ffma,
            b32.block0_tf32x3)
FRONTENDS = ["fused_frontend_tf32x3", "fused_frontend_padded_tf32x3",
             "fused_frontend_ffma", "fused_frontend_padded_ffma"]


def _counts():
    return [fn.launches for fn in WRAPPERS]


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor is no launch: each wrapper equals its plain version."""
    x = _t(np.random.default_rng(6).normal(0, 1, (2, 1000)))
    bank = _t(sinc_filterbank(70, 129, 16000))
    block = _block(3)
    before = _counts()
    with torch.inference_mode():
        for kind in ("tf32x3", "ffma"):
            torch.testing.assert_close(
                getattr(f32, f"fused_frontend_{kind}")(x, bank, *_bn()),
                fe.fused_frontend_reference(x, bank, *_bn()), rtol=0,
                atol=0)
            z = getattr(f32, f"fused_frontend_padded_{kind}")(x, bank,
                                                              *_bn())
            torch.testing.assert_close(
                z, fs.fused_frontend_padded_reference(x, bank, *_bn()),
                rtol=0, atol=0)
        torch.testing.assert_close(b32.block0_tf32x3(z, block),
                                   fs.fused_block0_reference(z, block),
                                   rtol=0, atol=0)
        # the routers send CPU tensors to the plain versions too
        torch.testing.assert_close(fe.fused_frontend(x, bank, *_bn()),
                                   fe.fused_frontend_reference(
                                       x, bank, *_bn()), rtol=0, atol=0)
        torch.testing.assert_close(fs.fused_block0(z, block),
                                   fs.fused_block0_reference(z, block),
                                   rtol=0, atol=0)
    assert _counts() == before


@pytest.mark.parametrize("router,kernel", [
    ("fused_frontend", "fused_frontend_ffma"),
    ("fused_frontend_padded", "fused_frontend_padded_tf32x3")])
def test_float32_frontends_route_to_their_f32_kernels(router, kernel):
    """On a card float32's plain store goes to the CUDA-core redesign (the
    3xTF32 one tips a node-order tie of the f32 forward) and its padded
    store to the 3xTF32 kernel: the guard names the kernel (a strided
    waveform here), and nothing is counted."""
    fn = getattr(fe if router == "fused_frontend" else fs, router)
    x = _FakeCuda(torch.zeros((2, 1000)), contiguous=False)
    bank = _FakeCuda(torch.zeros((70, 129)))
    before = _counts()
    with pytest.raises(ValueError, match=f"{kernel}: x and bank must be"):
        fn(x, bank, *_bn())
    assert _counts() == before


def test_float32_block0_routes_to_the_3xtf32_kernel():
    z = _FakeCuda(torch.zeros((2, 25, 300)), contiguous=False)
    with pytest.raises(ValueError, match="block0_tf32x3: expected a "
                       "contiguous"):
        fs.fused_block0(z, _block())


@pytest.mark.parametrize("name", FRONTENDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_frontend_wrappers_refuse_other_types(name, dtype):
    fn = getattr(f32, name)
    x = _FakeCuda(torch.zeros((2, 1000), dtype=dtype))
    bank = _FakeCuda(torch.zeros((70, 129), dtype=dtype))
    before = fn.launches
    with pytest.raises(TypeError, match="float32 only"):
        fn(x, bank, *_bn())
    assert fn.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_block0_wrapper_refuses_other_types(dtype):
    before = b32.block0_tf32x3.launches
    with pytest.raises(TypeError, match="float32"):
        b32.block0_tf32x3(_FakeCuda(torch.zeros((2, 25, 300), dtype=dtype)),
                          _block())
    assert b32.block0_tf32x3.launches == before


def test_wrappers_raise_on_a_device_that_is_not_a_card():
    x, bank = torch.zeros((2, 1000)), torch.zeros((70, 129))
    for fn in WRAPPERS[:4]:
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x.to("meta"), bank.to("meta"), *_bn())
    with pytest.raises(ValueError, match="unsupported device"):
        b32.block0_tf32x3(torch.zeros((2, 25, 300), device="meta"),
                          _block())
