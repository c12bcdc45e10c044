"""Fused sinc frontend: conv1d (C x 129) -> |.| -> max pool (3,3) -> eval
BatchNorm(1) -> SELU in one CUDA kernel (``csrc/fused_frontend.cu``).

Counterpart of ``aasist_tpu/ops/fused_frontend.py``.  ``fused_frontend``
launches the kernel for CUDA tensors and raises on anything it does not
take; for CPU tensors it computes the plain PyTorch version,
``fused_frontend_reference``.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

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


def fused_frontend(x: torch.Tensor, bank: torch.Tensor,
                   bn_p: Mapping[str, torch.Tensor],
                   bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, L) waveform -> (B, 1, C // 3, (L - 128) // 3) pooled, normalised
    and SELU'd frontend activations, in ``x``'s dtype.

    ``bank`` (C, 129) may carry freq-aug masking; ``bn_p`` holds the
    one-channel BatchNorm's ``weight``/``bias``, ``bn_s`` its ``mean``/
    ``var``.  Every launch adds one to ``fused_frontend.launches``.
    """
    if x.device.type == "cpu":
        return fused_frontend_reference(x, bank, bn_p, bn_s)
    if x.device.type != "cuda":
        raise ValueError(f"fused_frontend: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_frontend: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 2 or bank.dim() != 2 or bank.shape[1] != KSIZE:
        raise ValueError(f"fused_frontend: expected x (B, L) and bank "
                         f"(C, {KSIZE}), got {tuple(x.shape)} and "
                         f"{tuple(bank.shape)}")
    if bank.dtype != x.dtype or bank.device != x.device:
        raise TypeError("fused_frontend: bank must match x's dtype and "
                        "device")
    if not (x.is_contiguous() and bank.is_contiguous()):
        raise ValueError("fused_frontend: x and bank must be contiguous")
    b, length = x.shape
    c = bank.shape[0]
    f_out, t_out = c // 3, (length - (KSIZE - 1)) // 3
    if not (0 < b <= 65535 and f_out > 0 and t_out > 0):
        raise ValueError(f"fused_frontend: unsupported shape B={b}, "
                         f"L={length}, C={c}")
    sc = _fold_bn(bn_p, bn_s)
    if sc.device != x.device:
        raise TypeError("fused_frontend: BatchNorm tensors must be on "
                        "x's device")

    from aasist_tpu_torch.ops import _build
    lib = _build.load("fused_frontend").lib
    fn = lib.aasist_fused_frontend
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, 1, f_out, t_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), bank.data_ptr(), sc.data_ptr(),
                 out.data_ptr(), b, length, c, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_frontend: CUDA launch failed "
                           f"(cudaError_t {err})")
    fused_frontend.launches += 1
    return out


fused_frontend.launches = 0
