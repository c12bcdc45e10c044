"""Residual block 0 in float32 with conv2 on the tensor cores at f32
accuracy (``csrc/block0_f32.cu``): the f32 route of ``ops.fused_stack.
fused_block0``.

Counterpart of ``tools/fused_stack.py:_b0_run`` in float32, as
``ops.fused_stack.fused_block0_fma`` (the CUDA-core kernel, which stays as
the version this one is measured against) is; it computes that kernel's
function with conv2's products on ``mma.sync`` by the 3xTF32 split (each
f32 operand as a TF32 high and a TF32 low part, three products summed in
f32), conv1 + SELU built by producer warps while consumer warps run conv2,
and work items of 8 output rows and 16 pooled columns (the source's header
says why).  The output is NCHW, (B, C, F, T_z // 3), as the CUDA-core
kernel's.  float32 only: a bfloat16 frame raises ``TypeError``; CPU
tensors take the plain version.  ``block0_tf32x3_emulated`` states the
kernel's arithmetic in plain PyTorch for the CPU tests.

    block0_tf32x3(z, block)                   -> (B, C, F, T_z // 3)
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

from aasist_tpu_torch.ops import fused_stack as fs
from aasist_tpu_torch.ops.frontend_f32 import split_tf32

F32_TO = 16           # pooled columns of a work item
F32_RB = 8            # output rows of a band


def f32_work(b: int, f: int, t_out: int) -> Tuple[int, int, int]:
    """(n_tiles, n_bands, n_work) of the kernel for a (B, C, F, T_out)
    output."""
    n_tiles = -(-t_out // F32_TO)
    n_bands = -(-f // F32_RB)
    return n_tiles, n_bands, b * n_bands * n_tiles


def f32_items(b: int, f: int, t_out: int
              ) -> Iterator[Tuple[int, int, int, int, int]]:
    """Every work item of ``f32_work`` as (batch row, first row, end row,
    first pooled column, end column): the outputs each item stores."""
    n_tiles, n_bands, n_work = f32_work(b, f, t_out)
    for w in range(n_work):
        rest = w // n_tiles
        f0 = (rest % n_bands) * F32_RB
        t0 = (w % n_tiles) * F32_TO
        yield (rest // n_bands, f0, min(f0 + F32_RB, f), t0,
               min(t0 + F32_TO, t_out))


def block0_tf32x3_emulated(z: torch.Tensor, block: torch.nn.Module
                           ) -> torch.Tensor:
    """Block 0 on the f32 frame with the kernel's arithmetic in plain
    PyTorch: conv1 + bn2 + SELU in f32 (y1 zero outside the frame's times),
    conv2 with the 3xTF32 products (lo * hi and hi * lo first, then
    hi * hi), the downsample in f32, the pool, the two biases after it.
    Not a route of any wrapper: the CPU tests hold it against the JAX
    package's f32 block 0 at the card's gate."""
    p = fs.fold_block0(block)
    c = p.w1.shape[0]
    # the frame's border is conv1's padding; y1 is zero at t = -1, T_z
    y1 = F.pad(torch.selu(F.conv2d(z[:, None], p.w1.reshape(c, 1, 2, 3),
                                   p.shift1)), (1, 1))
    w2 = p.w2.permute(2, 0, 1).reshape(c, c, 2, 3)
    yh, yl = split_tf32(y1)
    wh, wl = split_tf32(w2)
    y2 = (F.conv2d(yl, wh) + F.conv2d(yh, wl)) + F.conv2d(yh, wh)
    ds = F.conv2d(z[:, None, 1:-1], p.wd.reshape(c, 1, 1, 3))
    return F.max_pool2d(y2 + ds, (1, 3)) + p.bias[None, :, None, None]


def block0_tf32x3(z: torch.Tensor, block: torch.nn.Module) -> torch.Tensor:
    """Residual block 0 (eval) on the zero-bordered float32 frame
    (B, F + 2, T_z + 2) -> (B, C, F, T_z // 3): ``ops.fused_stack.
    fused_block0``'s function, its f32 route.  Every launch adds one to
    ``block0_tf32x3.launches``."""
    fs._check_block0(block, "block0_tf32x3")
    if z.device.type == "cpu":
        return fs.fused_block0_reference(z, block)
    name = "block0_tf32x3"
    b, f_out, t_z, c, p = fs.check_frame(name, z, block, (torch.float32,))
    t_out = t_z // 3
    n_tiles, n_bands, n_work = f32_work(b, f_out, t_out)
    if n_work >= 2 ** 31:
        raise ValueError(f"{name}: {n_work} work items exceed the kernel's "
                         "int range")

    from aasist_tpu_torch.ops import _build
    fn = _build.load("block0_f32").lib.aasist_block0_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, c, f_out, t_out), dtype=z.dtype, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(z.data_ptr(), *(t.data_ptr() for t in p), out.data_ptr(),
                 b, f_out, t_z, c, n_tiles, n_bands, n_work, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
    block0_tf32x3.launches += 1
    return out


block0_tf32x3.launches = 0
