"""The sinc frontend fused with the head of residual block 0 in one CUDA
kernel (``csrc/frontend_head_pipe.cu``; the kernel it replaces,
``csrc/frontend_head.cu``, stays as ``fused_frontend_head_older``).

Counterpart of the kernel that ``tools/probe_feb0_ablate.py`` ablates:

    x0 = frontend(x)                       sinc conv, |.|, pool, BN, SELU
    y1 = selu(bn2(conv1(x0)))              block 0's conv1, (2,3), pad (1,1)

``fused_frontend_head(x, bank, bn_p, bn_s, block)`` returns ``(y1, x0)``:
``y1`` (B, 32, F + 1, T) and the frontend frame ``x0`` (B, F + 1, T) with
F = C // 3, T = (L - 128) // 3 and row F zero (24 rows, row 23 zero, for the
70-filter bank).  The TPU kernel stores both in one channel-major
(33, 24, B, n_tiles * u) array, Mosaic's native layout; here x0 is
row-major and y1 is stored channels last (``torch.channels_last``, (B, F +
1, T, 32) in memory: whole sectors, which an NCHW row of an odd number of
4-byte words is not; the source's header says why), NCHW by the older
kernel; the columns past T, tile padding there, do not exist.

conv1 sees zeros at frame row -1, row F, t = -1 and t >= T.  ``y1`` is not
masked at the edges (``fused_block0`` zeroes its own y1 tile there because
its conv2 pads; this function stores what conv1 + bn2 + SELU give).

float32 and bfloat16, f32 accumulation in both.  The wrapper launches the
kernel for CUDA tensors and raises on anything it does not take; CPU
tensors take the plain version, ``fused_frontend_head_reference``.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from aasist_tpu_torch import nn
from aasist_tpu_torch.ops import fused_frontend as fe
from aasist_tpu_torch.ops import fused_stack as fs


def fused_frontend_head_reference(x: torch.Tensor, bank: torch.Tensor,
                                  bn_p: Mapping[str, torch.Tensor],
                                  bn_s: Mapping[str, torch.Tensor],
                                  block: torch.nn.Module
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the frontend's own chain, then ``block``'s conv1,
    bn2 and SELU as ``ResidualBlock.forward`` runs them."""
    h = fe.fused_frontend_reference(x, bank, bn_p, bn_s)     # (B, 1, F, T)
    y1 = nn.selu(nn.batch_norm(block.bn2, block.conv1(h), axis=1))
    return y1, F.pad(h[:, 0], (0, 0, 0, 1))


SOURCE = "frontend_head_pipe"      # fused_frontend_head's kernel
OLDER_SOURCE = "frontend_head"     # fused_frontend_head_older's
MAX_ROWS = 24                      # pooled rows SOURCE's frame tile holds


def launch(x: torch.Tensor, bank: torch.Tensor,
           bn_p: Mapping[str, torch.Tensor], bn_s: Mapping[str, torch.Tensor],
           block: torch.nn.Module,
           defines: Optional[Mapping[str, object]] = None,
           source: str = SOURCE, name: str = "fused_frontend_head"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check a CUDA call of a head kernel and launch it: ``source`` is
    ``SOURCE`` or ``OLDER_SOURCE``, ``defines`` picks a compile-time variant
    of it (see its header; only the probe passes any), ``name`` heads the
    messages."""
    if source not in (SOURCE, OLDER_SOURCE):
        raise ValueError(f"{name}: unknown source {source!r}")
    fs._check_block0(block, name)
    ch = block.conv1.out_channels
    if ch != fs.BLOCK0_CHANNELS:
        raise ValueError(f"{name}: the kernel takes {fs.BLOCK0_CHANNELS} "
                         f"channels, the block has {ch}")
    b, length, c, sc = fe.check_args(
        name, x, bank, bn_p, bn_s,
        max_rows=MAX_ROWS if source == SOURCE else None)
    f_out, t_out = c // 3, (length - (fe.KSIZE - 1)) // 3
    p = fs.fold_block0(block)
    if p.w1.device != x.device:
        raise TypeError(f"{name}: the block's weights must be on x's device")

    from aasist_tpu_torch.ops import _build
    fn = getattr(_build.load(source, defines).lib, f"aasist_{source}")
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fmt = (torch.channels_last if source == SOURCE
           else torch.contiguous_format)
    y1 = torch.empty((b, ch, f_out + 1, t_out), dtype=x.dtype,
                     device=x.device, memory_format=fmt)
    x0 = torch.empty((b, f_out + 1, t_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), bank.data_ptr(), sc.data_ptr(),
                 p.w1.data_ptr(), p.shift1.data_ptr(), y1.data_ptr(),
                 x0.data_ptr(), b, length, c, ch, fe._DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
    return y1, x0


def fused_frontend_head(x: torch.Tensor, bank: torch.Tensor,
                        bn_p: Mapping[str, torch.Tensor],
                        bn_s: Mapping[str, torch.Tensor],
                        block: torch.nn.Module
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) waveform -> ``(y1, x0)``: block 0's SELU(bn2(conv1(x0)))
    (B, 32, C // 3 + 1, (L - 128) // 3) and the frontend frame ``x0``
    (B, C // 3 + 1, (L - 128) // 3), last row zero, in ``x``'s dtype; on a
    card from ``csrc/frontend_head_pipe.cu``, y1 channels last.

    ``bank``, ``bn_p`` and ``bn_s`` as ``ops.fused_frontend.fused_frontend``
    (C // 3 <= 24 on a card); ``block`` is the first
    ``models.layers.ResidualBlock`` (1 -> 32 channels, with a downsample).
    Every launch adds one to ``fused_frontend_head.launches``.
    """
    if x.device.type == "cpu":
        fs._check_block0(block, "fused_frontend_head")
        return fused_frontend_head_reference(x, bank, bn_p, bn_s, block)
    out = launch(x, bank, bn_p, bn_s, block)
    fused_frontend_head.launches += 1
    return out


def fused_frontend_head_older(x: torch.Tensor, bank: torch.Tensor,
                              bn_p: Mapping[str, torch.Tensor],
                              bn_s: Mapping[str, torch.Tensor],
                              block: torch.nn.Module
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_frontend_head`` on the older kernel (``csrc/
    frontend_head.cu``, y1 NCHW).  Every launch adds one to
    ``fused_frontend_head_older.launches``."""
    if x.device.type == "cpu":
        fs._check_block0(block, "fused_frontend_head_older")
        return fused_frontend_head_reference(x, bank, bn_p, bn_s, block)
    out = launch(x, bank, bn_p, bn_s, block, source=OLDER_SOURCE,
                 name="fused_frontend_head_older")
    fused_frontend_head_older.launches += 1
    return out


fused_frontend_head.launches = 0
fused_frontend_head_older.launches = 0
