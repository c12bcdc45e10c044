"""Fused sinc frontend: conv1d (C x 129) -> |.| -> max pool (3,3) -> eval
BatchNorm(1) -> SELU in one CUDA kernel.

Counterpart of ``aasist_tpu/ops/fused_frontend.py``.  ``fused_frontend``
picks the kernel by the input's type: bfloat16 CUDA tensors go to the
tensor-core kernel (``ops/frontend_variants.py:fused_frontend_dot_plain``,
``csrc/frontend_dot.cu``), float32 ones to the CUDA-core redesign
(``ops/frontend_f32.py:fused_frontend_ffma``, ``csrc/frontend_ffma.cu``),
whose f32 sums meet the f32 path's gate that bf16 operands cannot and are
bit for bit those of the older CUDA-core kernel (``fused_frontend_fma``,
``csrc/fused_frontend.cu``).  That kernel takes any other type (float32
and bfloat16; it raises on the rest) and stays as the version the
redesign is measured against.  Each launches its kernel or raises on
anything it does not take; CPU tensors take the plain PyTorch version,
``fused_frontend_reference``.  There is no fallback from one to another.
``fused_frontend_sharded`` splits a batch over a
``parallel/mesh.py:DataMesh``, each part through ``fused_frontend`` on its
own device (the JAX package's ``shard_map``).
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from aasist_tpu_torch import nn

KSIZE = 129            # sinc taps
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scalar_bn(h: torch.Tensor, bn_p: Mapping[str, torch.Tensor],
               bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return ((h - bn_s["mean"]) * torch.rsqrt(bn_s["var"] + nn.BN_EPS)
            * bn_p["weight"] + bn_p["bias"])


def fused_frontend_reference(x: torch.Tensor, bank: torch.Tensor,
                             bn_p: Mapping[str, torch.Tensor],
                             bn_s: Mapping[str, torch.Tensor]
                             ) -> torch.Tensor:
    """The plain version: (B, L) -> (B, 1, C // 3, (L - 128) // 3)."""
    h = F.conv1d(x[:, None, :], bank[:, None, :])            # (B, C, L')
    h = F.max_pool2d(h.abs()[:, None], 3)                    # floor pool
    return torch.selu(_scalar_bn(h, bn_p, bn_s))


def _fold_bn(bn_p, bn_s) -> torch.Tensor:
    """(scale, shift) in float32 on the tensors' device, no host sync."""
    w = bn_p["weight"].float().reshape(1)
    inv = torch.rsqrt(bn_s["var"].float().reshape(1) + nn.BN_EPS)
    scale = w * inv
    shift = (bn_p["bias"].float().reshape(1)
             - bn_s["mean"].float().reshape(1) * scale)
    return torch.cat([scale, shift]).contiguous()


def check_args(name: str, x: torch.Tensor, bank: torch.Tensor,
               bn_p: Mapping[str, torch.Tensor],
               bn_s: Mapping[str, torch.Tensor], dtypes=_DTYPES,
               max_rows: Optional[int] = None
               ) -> Tuple[int, int, int, torch.Tensor]:
    """Raise on what a frontend kernel does not take (device, one of
    ``dtypes``, shapes, more than ``max_rows`` pooled rows, contiguity);
    ``name`` heads the messages.  Returns (B, L, C, the folded BatchNorm's
    (scale, shift) on the device)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: dtype {x.dtype} not supported ({names}"
                        f"{' only' if len(dtypes) == 1 else ''})")
    if x.dim() != 2 or bank.dim() != 2 or bank.shape[1] != KSIZE:
        raise ValueError(f"{name}: expected x (B, L) and bank (C, {KSIZE}), "
                         f"got {tuple(x.shape)} and {tuple(bank.shape)}")
    if bank.dtype != x.dtype or bank.device != x.device:
        raise TypeError(f"{name}: bank must match x's dtype and device")
    if not (x.is_contiguous() and bank.is_contiguous()):
        raise ValueError(f"{name}: x and bank must be contiguous")
    b, length = x.shape
    c = bank.shape[0]
    if not (0 < b <= 65535 and 0 < c // 3 <= (max_rows or c)
            and (length - (KSIZE - 1)) // 3 > 0):
        raise ValueError(f"{name}: unsupported shape B={b}, L={length}, "
                         f"C={c}")
    sc = _fold_bn(bn_p, bn_s)
    if sc.device != x.device:
        raise TypeError(f"{name}: BatchNorm tensors must be on x's device")
    return b, length, c, sc


def launch(name: str, x: torch.Tensor, bank: torch.Tensor,
           bn_p: Mapping[str, torch.Tensor], bn_s: Mapping[str, torch.Tensor],
           padded: bool) -> torch.Tensor:
    """Check a CUDA call of the frontend kernel and launch it: the output is
    (B, 1, F, T), or with ``padded`` the (B, F + 2, T + 2) zero-bordered
    frame.  Raises on what the kernel does not take and when the launch
    fails; ``name`` heads the messages."""
    b, length, c, sc = check_args(name, x, bank, bn_p, bn_s)
    f_out, t_out = c // 3, (length - (KSIZE - 1)) // 3

    from aasist_tpu_torch.ops import _build
    lib = _build.load("fused_frontend").lib
    fn = (lib.aasist_fused_frontend_padded if padded
          else lib.aasist_fused_frontend)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shape = (b, f_out + 2, t_out + 2) if padded else (b, 1, f_out, t_out)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), bank.data_ptr(), sc.data_ptr(),
                 out.data_ptr(), b, length, c, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
    return out


def fused_frontend_fma(x: torch.Tensor, bank: torch.Tensor,
                       bn_p: Mapping[str, torch.Tensor],
                       bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The CUDA-core kernel (``csrc/fused_frontend.cu``), float32 or
    bfloat16: (B, L) waveform -> (B, 1, C // 3, (L - 128) // 3).  Arguments
    as ``fused_frontend``.  Every launch adds one to
    ``fused_frontend_fma.launches``."""
    if x.device.type == "cpu":
        return fused_frontend_reference(x, bank, bn_p, bn_s)
    out = launch("fused_frontend_fma", x, bank, bn_p, bn_s, padded=False)
    fused_frontend_fma.launches += 1
    return out


def fused_frontend(x: torch.Tensor, bank: torch.Tensor,
                   bn_p: Mapping[str, torch.Tensor],
                   bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, L) waveform -> (B, 1, C // 3, (L - 128) // 3) pooled, normalised
    and SELU'd frontend activations, in ``x``'s dtype.

    ``bank`` (C, 129) may carry freq-aug masking; ``bn_p`` holds the
    one-channel BatchNorm's ``weight``/``bias``, ``bn_s`` its ``mean``/
    ``var``.  bfloat16 CUDA tensors run the bf16 tensor-core kernel,
    float32 ones the CUDA-core redesign, anything else on a device the
    older CUDA-core kernel (module docstring); the kernel's wrapper counts
    the launch.
    """
    if x.device.type == "cpu":
        return fused_frontend_reference(x, bank, bn_p, bn_s)
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        from aasist_tpu_torch.ops.frontend_variants import (
            fused_frontend_dot_plain)
        return fused_frontend_dot_plain(x, bank, bn_p, bn_s)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        from aasist_tpu_torch.ops import frontend_f32
        return frontend_f32.fused_frontend_ffma(x, bank, bn_p, bn_s)
    return fused_frontend_fma(x, bank, bn_p, bn_s)


fused_frontend_fma.launches = 0


def fused_frontend_mesh(x: torch.Tensor, bank: torch.Tensor,
                        bn_p: Mapping[str, torch.Tensor],
                        bn_s: Mapping[str, torch.Tensor], *,
                        mesh=None) -> torch.Tensor:
    """``fused_frontend`` on one device, or split over ``mesh``
    (``fused_frontend_sharded``): the models route through this call."""
    if mesh is None:
        return fused_frontend(x, bank, bn_p, bn_s)
    return fused_frontend_sharded(x, bank, bn_p, bn_s, mesh=mesh)


def fused_frontend_sharded(x: torch.Tensor, bank: torch.Tensor,
                           bn_p: Mapping[str, torch.Tensor],
                           bn_s: Mapping[str, torch.Tensor], *,
                           mesh) -> torch.Tensor:
    """``fused_frontend`` over the rows of ``x`` split evenly over
    ``mesh.devices``: each part, with copies of the filterbank and the
    BatchNorm tensors, goes through the kernel on its device (the plain
    version on a CPU entry), and the outputs are concatenated on ``x``'s
    device in row order.  The frontend is row-independent, so no
    collective is needed and the result is the one-device kernel's."""
    outs = []
    for part, device in zip(mesh.parts(x.shape[0]), mesh.devices):
        def to(t):
            return t.to(device, non_blocking=True)
        outs.append(fused_frontend(
            to(x[part]).contiguous(), to(bank),
            {k: to(v) for k, v in bn_p.items()},
            {k: to(v) for k, v in bn_s.items()}))
    return torch.cat([o.to(x.device) for o in outs])
