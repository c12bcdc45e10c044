"""The sinc frontend and residual block 0 as a pair of CUDA kernels.

Counterpart of ``tools/fused_stack.py`` (the JAX package's opt-in
``use_fused_stack`` eval path): the exact replacement, to rounding, for

    sinc conv (C x 129) -> |.| -> maxpool (3,3) -> BN -> SELU     (frontend)
    -> conv1 (1->C, (2,3)) -> bn2 -> SELU -> conv2 (C->C, (2,3))
       + downsample (1->C, (1,3)) -> maxpool (1,3)                (block 0)

``fused_frontend_padded`` writes the frontend into a zero-bordered
(B, F + 2, T_z + 2) frame, ``fused_block0`` takes that frame to the block's
pooled (B, C, F, T_z // 3) output, and ``fused_frontend_block0`` chains the
two.  Each picks its kernel by the input's type:

    bfloat16   the tensor-core frontend's padded store
               (``ops/frontend_variants.py:fused_frontend_dot_padded``,
               ``csrc/frontend_dot.cu``), then the warp-specialised block 0
               (``ops/block0_pipe.py:block0_pipe``, ``csrc/block0_pipe.cu``),
               whose output is channels last;
    float32    the 3xTF32 frontend's padded store
               (``ops/frontend_f32.py:fused_frontend_padded_tf32x3``,
               ``csrc/frontend_f32.cu``), then the warp-specialised block 0
               with conv2 on the tensor cores by the 3xTF32 split
               (``ops/block0_f32.py:block0_tf32x3``, ``csrc/block0_f32.cu``):
               f32 sums of split products, which meet the f32 path's gate
               that bf16 tensor-core operands cannot.

The older kernels stay callable as the versions the new ones are measured
against: ``fused_block0_mma`` (bf16, also the base of the probe builds of
``ops/block0_variants.py``), and the CUDA-core kernels
``fused_frontend_padded_fma`` (``csrc/fused_frontend.cu``, float32 and
bfloat16; the route of any other type, which it refuses) and
``fused_block0_fma`` (``csrc/fused_block0.cu``, float32).  Each wrapper launches its kernel for CUDA
tensors and raises on anything the kernel does not take; for CPU tensors it
computes its plain PyTorch version (``*_reference``).  There is no fallback
from one to another.

The TPU kernels' mod-9 / mod-3 polyphase packing and K=18 / off-split
weight packing existed only because Mosaic has no stride-3 lane access;
here the weights are folded (``fold_block0``) and laid out for the CUDA
kernel on the device, with no host sync.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from aasist_tpu_torch import nn
from aasist_tpu_torch.ops import fused_frontend as fe

BLOCK0_CHANNELS = 32      # the only width the block-0 kernel is built for


def fused_frontend_padded_reference(x: torch.Tensor, bank: torch.Tensor,
                                    bn_p: Mapping[str, torch.Tensor],
                                    bn_s: Mapping[str, torch.Tensor]
                                    ) -> torch.Tensor:
    """The plain version: (B, L) -> (B, C // 3 + 2, (L - 128) // 3 + 2),
    the frontend's output with a zero border of one row and one column."""
    return F.pad(fe.fused_frontend_reference(x, bank, bn_p, bn_s)[:, 0],
                 (1, 1, 1, 1))


def fused_frontend_padded_fma(x: torch.Tensor, bank: torch.Tensor,
                              bn_p: Mapping[str, torch.Tensor],
                              bn_s: Mapping[str, torch.Tensor]
                              ) -> torch.Tensor:
    """The CUDA-core kernel's padded store (``csrc/fused_frontend.cu``),
    float32 or bfloat16.  Arguments and output as
    ``fused_frontend_padded``.  Every launch adds one to
    ``fused_frontend_padded_fma.launches``."""
    if x.device.type == "cpu":
        return fused_frontend_padded_reference(x, bank, bn_p, bn_s)
    out = fe.launch("fused_frontend_padded_fma", x, bank, bn_p, bn_s,
                    padded=True)
    fused_frontend_padded_fma.launches += 1
    return out


def fused_frontend_padded(x: torch.Tensor, bank: torch.Tensor,
                          bn_p: Mapping[str, torch.Tensor],
                          bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, L) waveform -> the frontend's (B, C // 3, (L - 128) // 3) output
    inside a zero-bordered (B, C // 3 + 2, (L - 128) // 3 + 2) frame, in
    ``x``'s dtype: the input layout of ``fused_block0``.

    Arguments as ``ops.fused_frontend.fused_frontend``.  bfloat16 CUDA
    tensors run the bf16 tensor-core kernel, float32 ones the 3xTF32
    kernel, anything else on a device the CUDA-core kernel (module
    docstring); the kernel's wrapper counts the launch.
    """
    if x.device.type == "cpu":
        return fused_frontend_padded_reference(x, bank, bn_p, bn_s)
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        from aasist_tpu_torch.ops.frontend_variants import (
            fused_frontend_dot_padded)
        return fused_frontend_dot_padded(x, bank, bn_p, bn_s)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        from aasist_tpu_torch.ops.frontend_f32 import (
            fused_frontend_padded_tf32x3)
        return fused_frontend_padded_tf32x3(x, bank, bn_p, bn_s)
    return fused_frontend_padded_fma(x, bank, bn_p, bn_s)


fused_frontend_padded_fma.launches = 0


class Block0Params(NamedTuple):
    """Block 0's eval weights folded for the kernel, float32 (the block-0
    half of ``tools/fused_stack.py:FusedStackParams``; the frontend's BN
    fold is ``ops.fused_frontend._fold_bn``)."""
    w1: torch.Tensor       # (C, 6) conv1 taps [df*3+dt] times bn2's scale
    shift1: torch.Tensor   # (C,) bn2 shift + conv1 bias times bn2's scale
    w2: torch.Tensor       # (C, 6, C) conv2 taps [ci][df*3+dt][co]
    wd: torch.Tensor       # (C, 3) downsample taps
    bias: torch.Tensor     # (C,) conv2 bias + downsample bias


def _check_block0(block: torch.nn.Module, name: str) -> None:
    ds = getattr(block, "conv_downsample", None)
    if ds is None or block.conv1.in_channels != 1 or not block.pool:
        raise ValueError(
            f"{name}: needs the first residual block, 1 -> C channels with "
            "a downsample conv (filts[1] = [1, C] with C > 1) and its (1, 3) "
            "max pool")


def takes_block0(block: torch.nn.Module) -> bool:
    """Whether the block-0 kernels take ``block``: the first residual
    block, 1 -> ``BLOCK0_CHANNELS`` channels with a downsample conv."""
    try:
        _check_block0(block, "takes_block0")
    except ValueError:
        return False
    return block.conv1.out_channels == BLOCK0_CHANNELS


def _bias(conv: torch.nn.Conv2d) -> torch.Tensor:
    if conv.bias is None:
        return conv.weight.new_zeros(conv.out_channels, dtype=torch.float32)
    return conv.bias.detach().float()


def fold_block0(block: torch.nn.Module) -> Block0Params:
    """Fold ``block``'s bn2 and conv1 bias into conv1, and lay out its
    weights for ``csrc/fused_block0.cu``, on the weights' device."""
    _check_block0(block, "fold_block0")
    c1, bn, c2, ds = block.conv1, block.bn2, block.conv2, block.conv_downsample
    c = c1.out_channels
    scale = bn.weight.detach().float() * torch.rsqrt(
        bn.running_var.float() + nn.BN_EPS)
    shift = (bn.bias.detach().float() - bn.running_mean.float() * scale
             + _bias(c1) * scale)
    w1 = c1.weight.detach().float().reshape(c, 6) * scale[:, None]
    w2 = c2.weight.detach().float().permute(1, 2, 3, 0).reshape(c, 6, c)
    wd = ds.weight.detach().float().reshape(c, 3)
    return Block0Params(w1.contiguous(), shift.contiguous(), w2.contiguous(),
                        wd.contiguous(), (_bias(c2) + _bias(ds)).contiguous())


def fused_block0_reference(z: torch.Tensor, block: torch.nn.Module
                           ) -> torch.Tensor:
    """The plain version: the frame's interior through ``block``'s own
    chain (F.conv2d, F.batch_norm, SELU, F.conv2d + downsample,
    F.max_pool2d): (B, F + 2, T_z + 2) -> (B, C, F, T_z // 3)."""
    return block(z[:, None, 1:-1, 1:-1])


def check_frame(name: str, z: torch.Tensor, block: torch.nn.Module,
                dtypes: Tuple[torch.dtype, ...]
                ) -> Tuple[int, int, int, int, Block0Params]:
    """Raise on a frame or block that the block-0 kernels do not take
    (device, one of ``dtypes``, shape, contiguity, width, the weights'
    device); ``name`` heads the messages.  Returns (B, F, T_z, C, the
    folded weights)."""
    if z.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {z.device}")
    if z.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {z.dtype} not supported ("
                        + " or ".join(str(d).split(".")[-1] for d in dtypes)
                        + ")")
    if z.dim() != 3 or not z.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (B, F + 2, "
                         f"T_z + 2) frame, got {tuple(z.shape)}")
    b, f_out, t_z = z.shape[0], z.shape[1] - 2, z.shape[2] - 2
    c = block.conv1.out_channels
    if c != BLOCK0_CHANNELS:
        raise ValueError(f"{name}: the kernel takes "
                         f"{BLOCK0_CHANNELS} channels, the block has {c}")
    if not (b > 0 and f_out > 0 and t_z // 3 > 0):
        raise ValueError(f"{name}: unsupported frame "
                         f"{tuple(z.shape)}")
    p = fold_block0(block)
    if p.w1.device != z.device:
        raise TypeError(f"{name}: the block's weights must be on z's "
                        "device")
    return b, f_out, t_z, c, p


def launch_block0(name: str, z: torch.Tensor, block: torch.nn.Module,
                  defines: Optional[Mapping[str, object]] = None,
                  bias: Optional[torch.Tensor] = None,
                  dtypes: Tuple[torch.dtype, ...] = tuple(fe._DTYPES)
                  ) -> torch.Tensor:
    """Check a CUDA call of the block-0 kernel of ``csrc/fused_block0.cu``
    and launch it: the frame (B, F + 2, T_z + 2) -> (B, C, F, T_z // 3).
    ``defines`` picks a compile-time variant of the source and ``bias``
    replaces ``fold_block0``'s (``ops.block0_variants`` passes both);
    ``dtypes`` are the frame types the build takes."""
    b, f_out, t_z, c, p = check_frame(name, z, block, dtypes)
    if bias is not None:
        p = p._replace(bias=bias)

    from aasist_tpu_torch.ops import _build
    fn = _build.load("fused_block0", defines).lib.aasist_fused_block0
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, c, f_out, t_z // 3), dtype=z.dtype,
                      device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(z.data_ptr(), *(t.data_ptr() for t in p), out.data_ptr(),
                 b, f_out, t_z, c, fe._DTYPES[z.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed "
                           f"(cudaError_t {err})")
    return out


def fused_block0_fma(z: torch.Tensor, block: torch.nn.Module
                     ) -> torch.Tensor:
    """Block 0 with conv2 on the CUDA cores (``csrc/fused_block0.cu``,
    ``block0_fma_kernel``), float32 only.  Arguments and output as
    ``fused_block0``.  Every launch adds one to
    ``fused_block0_fma.launches``."""
    _check_block0(block, "fused_block0_fma")
    if z.device.type == "cpu":
        return fused_block0_reference(z, block)
    out = launch_block0("fused_block0_fma", z, block,
                        dtypes=(torch.float32,))
    fused_block0_fma.launches += 1
    return out


def fused_block0_mma(z: torch.Tensor, block: torch.nn.Module
                     ) -> torch.Tensor:
    """The older bf16 block-0 kernel, its phases one after another
    (``csrc/fused_block0.cu``, ``block0_tc_kernel``), bfloat16 only.
    Arguments and output as ``fused_block0``.  Every launch adds one to
    ``fused_block0_mma.launches``."""
    _check_block0(block, "fused_block0_mma")
    if z.device.type == "cpu":
        return fused_block0_reference(z, block)
    out = launch_block0("fused_block0_mma", z, block,
                        dtypes=(torch.bfloat16,))
    fused_block0_mma.launches += 1
    return out


def fused_block0(z: torch.Tensor, block: torch.nn.Module) -> torch.Tensor:
    """Residual block 0 (eval) on the zero-bordered frame that
    ``fused_frontend_padded`` writes: (B, F + 2, T_z + 2) ->
    (B, C, F, T_z // 3), in ``z``'s dtype.

    ``block`` is a ``models.layers.ResidualBlock`` from 1 to C channels
    with a downsample; the kernels take C = 32.  bfloat16 CUDA frames run
    ``block0_pipe``, float32 ones ``block0_tf32x3``, anything else on a
    device ``fused_block0_fma`` (module docstring); the kernel's wrapper
    counts the launch.
    """
    _check_block0(block, "fused_block0")
    if z.device.type == "cpu":
        return fused_block0_reference(z, block)
    if z.device.type == "cuda" and z.dtype == torch.bfloat16:
        from aasist_tpu_torch.ops.block0_pipe import block0_pipe
        return block0_pipe(z, block)
    if z.device.type == "cuda" and z.dtype == torch.float32:
        from aasist_tpu_torch.ops.block0_f32 import block0_tf32x3
        return block0_tf32x3(z, block)
    return fused_block0_fma(z, block)


fused_block0_fma.launches = 0
fused_block0_mma.launches = 0


def fused_frontend_block0(x: torch.Tensor, bank: torch.Tensor,
                          bn_p: Mapping[str, torch.Tensor],
                          bn_s: Mapping[str, torch.Tensor],
                          block: torch.nn.Module) -> torch.Tensor:
    """(B, L) waveform -> block 0's (B, C, C_bank // 3, (L - 128) // 9)
    output: ``fused_frontend_padded`` then ``fused_block0``."""
    return fused_block0(fused_frontend_padded(x, bank, bn_p, bn_s), block)
