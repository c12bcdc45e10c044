"""The fused sinc frontend in float32 at f32 accuracy, in two designs for
Hopper: on the CUDA cores (``csrc/frontend_ffma.cu``), the f32 route of
``ops.fused_frontend.fused_frontend``, and on the tensor cores by the
3xTF32 split (``csrc/frontend_f32.cu``), the f32 route of
``ops.fused_stack.fused_frontend_padded``.

Counterparts of ``aasist_tpu/ops/fused_frontend.py:_run`` and
``tools/fused_stack.py:_fe_run`` in float32, as the older CUDA-core kernel
(``fused_frontend_fma``, ``fused_frontend_padded_fma``) is; both compute
that kernel's function, sinc conv (C x 129) -> |.| -> max pool (3,3) ->
eval BatchNorm(1) -> SELU, and store it as

    fused_frontend_ffma(x, bank, bn_p, bn_s)           -> (B, 1, C // 3, T)
    fused_frontend_padded_ffma(x, bank, bn_p, bn_s)    -> (B, C // 3 + 2, T + 2)
    fused_frontend_tf32x3(x, bank, bn_p, bn_s)         -> (B, 1, C // 3, T)
    fused_frontend_padded_tf32x3(x, bank, bn_p, bn_s)  -> (B, C // 3 + 2, T + 2)

with T = (L - 128) // 3; the padded ones write the zero-bordered frame
that block 0 reads.  The ``ffma`` kernel sums each conv output as one fmaf
chain in the older kernel's order, so its output is that kernel's bit for
bit; the ``tf32x3`` kernel runs the conv's products on ``mma.sync`` (each
f32 operand as a TF32 high part and a TF32 low part, three products summed
in f32), which rounds differently: enough to tip a near-tie of the model's
node order that the f32 forward without kernels falls the other way, so
the Scorer's frontend path keeps the CUDA cores.  float32 only: a bfloat16
or other CUDA tensor raises ``TypeError`` (the routers send bf16 to
``csrc/frontend_dot.cu``); CPU tensors take the plain versions.
``split_tf32`` and ``frontend_tf32x3_emulated`` state the split and the
tensor-core kernel's arithmetic in plain PyTorch, for the CPU tests.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from aasist_tpu_torch.ops import fused_frontend as fe

ROWS = 24              # pooled rows the kernel's columns hold
F32_TILE = 128         # pooled columns of one work item of the kernel


def f32_work(b: int, length: int) -> Tuple[int, int]:
    """The kernel's work decomposition for a (b, length) waveform:
    (n_tiles, n_work).  Item w covers batch row w // n_tiles and pooled
    columns [(w % n_tiles) * F32_TILE, + F32_TILE) clipped to T."""
    t_out = (length - (fe.KSIZE - 1)) // 3
    n_tiles = -(-t_out // F32_TILE)
    return n_tiles, b * n_tiles


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``t``: hi is t rounded to TF32 (10 mantissa
    bits; to nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and lo
    is t - hi rounded the same way, so that hi + lo is t to ~2^-22."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = tf32(t)
    return hi, tf32(t - hi)


def conv1d_tf32x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv1d(x, w)`` in float32 with the kernels' 3xTF32 products:
    lo * hi and hi * lo summed first, then hi * hi (lo * lo dropped).
    Each product of two TF32 values is exact in f32."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    return (F.conv1d(xl, wh) + F.conv1d(xh, wl)) + F.conv1d(xh, wh)


def frontend_tf32x3_emulated(x: torch.Tensor, bank: torch.Tensor,
                             bn_p: Mapping[str, torch.Tensor],
                             bn_s: Mapping[str, torch.Tensor]
                             ) -> torch.Tensor:
    """The plain version with the kernel's 3xTF32 conv: (B, L) float32 ->
    (B, 1, C // 3, (L - 128) // 3).  Not a route of any wrapper: the CPU
    tests hold it against the JAX package's f32 frontend at the card's
    gate, which shows that the split keeps f32 accuracy."""
    h = conv1d_tf32x3(x[:, None, :], bank[:, None, :])
    h = F.max_pool2d(h.abs()[:, None], 3)
    return torch.selu(fe._scalar_bn(h, bn_p, bn_s))


def _launch(name: str, x: torch.Tensor, bank: torch.Tensor, bn_p, bn_s,
            layout: str) -> torch.Tensor:
    b, length, c, sc = fe.check_args(name, x, bank, bn_p, bn_s,
                                     dtypes=(torch.float32,), max_rows=ROWS)
    t_out = (length - (fe.KSIZE - 1)) // 3
    f_out = c // 3
    n_tiles, n_work = f32_work(b, length)
    if n_work >= 2 ** 31:
        raise ValueError(f"{name}: {n_work} work items exceed the kernel's "
                         "int range")

    from aasist_tpu_torch.ops import _build
    fn = getattr(_build.load("frontend_f32").lib,
                 f"aasist_frontend_f32_{layout}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shape = ((b, 1, f_out, t_out) if layout == "plain"
             else (b, f_out + 2, t_out + 2))
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), bank.data_ptr(), sc.data_ptr(),
                 out.data_ptr(), b, length, c, n_tiles, n_work, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
    return out


def fused_frontend_tf32x3(x: torch.Tensor, bank: torch.Tensor,
                          bn_p: Mapping[str, torch.Tensor],
                          bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, L) float32 waveform -> the frontend in the Scorer's layout,
    (B, 1, C // 3, (L - 128) // 3), float32: the f32 route of
    ``ops.fused_frontend.fused_frontend``.  Arguments as there; ``bank``
    may carry freq-aug masking.  Every launch adds one to
    ``fused_frontend_tf32x3.launches``."""
    if x.device.type == "cpu":
        return fe.fused_frontend_reference(x, bank, bn_p, bn_s)
    out = _launch("fused_frontend_tf32x3", x, bank, bn_p, bn_s, "plain")
    fused_frontend_tf32x3.launches += 1
    return out


def fused_frontend_padded_tf32x3(x: torch.Tensor, bank: torch.Tensor,
                                 bn_p: Mapping[str, torch.Tensor],
                                 bn_s: Mapping[str, torch.Tensor]
                                 ) -> torch.Tensor:
    """(B, L) float32 waveform -> the frontend inside the zero-bordered
    (B, C // 3 + 2, (L - 128) // 3 + 2) frame that block 0 reads, float32:
    the f32 route of ``ops.fused_stack.fused_frontend_padded``.  Arguments
    as ``fused_frontend_tf32x3``.  Every launch adds one to
    ``fused_frontend_padded_tf32x3.launches``."""
    if x.device.type == "cpu":
        return F.pad(fe.fused_frontend_reference(x, bank, bn_p, bn_s)[:, 0],
                     (1, 1, 1, 1))
    out = _launch("fused_frontend_padded_tf32x3", x, bank, bn_p, bn_s,
                  "padded")
    fused_frontend_padded_tf32x3.launches += 1
    return out


def _launch_ffma(name: str, x: torch.Tensor, bank: torch.Tensor, bn_p,
                 bn_s, layout: str,
                 defines: Optional[Mapping[str, object]] = None
                 ) -> torch.Tensor:
    b, length, c, sc = fe.check_args(name, x, bank, bn_p, bn_s,
                                     dtypes=(torch.float32,))
    t_out = (length - (fe.KSIZE - 1)) // 3
    f_out = c // 3

    from aasist_tpu_torch.ops import _build
    fn = getattr(_build.load("frontend_ffma", defines).lib,
                 f"aasist_frontend_ffma_{layout}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shape = ((b, 1, f_out, t_out) if layout == "plain"
             else (b, f_out + 2, t_out + 2))
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), bank.data_ptr(), sc.data_ptr(),
                 out.data_ptr(), b, length, c, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
    return out


def fused_frontend_ffma(x: torch.Tensor, bank: torch.Tensor,
                        bn_p: Mapping[str, torch.Tensor],
                        bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, L) float32 waveform -> the frontend in the Scorer's layout,
    (B, 1, C // 3, (L - 128) // 3), float32, on the CUDA cores: the f32
    route of ``ops.fused_frontend.fused_frontend``.  Arguments as
    ``fused_frontend_tf32x3``.  Every launch adds one to
    ``fused_frontend_ffma.launches``."""
    if x.device.type == "cpu":
        return fe.fused_frontend_reference(x, bank, bn_p, bn_s)
    out = _launch_ffma("fused_frontend_ffma", x, bank, bn_p, bn_s, "plain")
    fused_frontend_ffma.launches += 1
    return out


def fused_frontend_padded_ffma(x: torch.Tensor, bank: torch.Tensor,
                               bn_p: Mapping[str, torch.Tensor],
                               bn_s: Mapping[str, torch.Tensor]
                               ) -> torch.Tensor:
    """(B, L) float32 waveform -> the frontend inside the zero-bordered
    (B, C // 3 + 2, (L - 128) // 3 + 2) frame, float32, on the CUDA cores:
    measured beside ``fused_frontend_padded_tf32x3``, which takes the
    route.  Every launch adds one to
    ``fused_frontend_padded_ffma.launches``."""
    if x.device.type == "cpu":
        return F.pad(fe.fused_frontend_reference(x, bank, bn_p, bn_s)[:, 0],
                     (1, 1, 1, 1))
    out = _launch_ffma("fused_frontend_padded_ffma", x, bank, bn_p, bn_s,
                       "padded")
    fused_frontend_padded_ffma.launches += 1
    return out


fused_frontend_tf32x3.launches = 0
fused_frontend_padded_tf32x3.launches = 0
fused_frontend_ffma.launches = 0
fused_frontend_padded_ffma.launches = 0
