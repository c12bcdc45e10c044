"""The fused sinc frontend computed on the tensor cores, in two store
layouts (``csrc/frontend_dot.cu``).

Counterpart of the two dot formulations of the TPU frontend,
``tools/probe_frontend_variants.py:run_v2`` (filter-major store) and
``tools/probe_fe_fix.py:run_v2bm`` (batch-major store, which block 0's conv
reads without a transpose).  Both compute ``ops.fused_frontend``'s function,
sinc conv (C x 129) -> |.| -> max pool (3,3) -> eval BatchNorm(1) -> SELU,
padded to 24 rows:

    fused_frontend_dot_fm(x, bank, bn_p, bn_s) -> (24, B, T)
    fused_frontend_dot_bm(x, bank, bn_p, bn_s) -> (B, 24, T)

with T = (L - 128) // 3, rows 0 .. C // 3 - 1 the frontend's output and the
rows above them zero (row 23 for the 70-filter bank).  The TPU kernels store
n_tiles * u columns; the columns past T are their tile padding and no part
of the function.  Their host-side phase split (``make_xt``) and the G / u
block sizes have no counterpart: the kernel reads the waveform directly.

The kernel is bfloat16 only: bf16 operands on ``mma.sync``, f32
accumulation, one rounding at the store.  A float32 CUDA tensor raises
``TypeError``; it is never handed to another kernel or to the plain
version.  CPU tensors of either type take the plain versions
(``*_reference``).
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch
import torch.nn.functional as F

from aasist_tpu_torch.ops import fused_frontend as fe

ROWS = 24              # stored rows: C // 3 of the frontend, the rest zero


def fused_frontend_dot_bm_reference(x: torch.Tensor, bank: torch.Tensor,
                                    bn_p: Mapping[str, torch.Tensor],
                                    bn_s: Mapping[str, torch.Tensor]
                                    ) -> torch.Tensor:
    """The plain version: (B, L) -> (B, 24, (L - 128) // 3), the frontend's
    rows padded with zero rows to 24."""
    h = fe.fused_frontend_reference(x, bank, bn_p, bn_s)[:, 0]
    return F.pad(h, (0, 0, 0, ROWS - h.shape[1]))


def fused_frontend_dot_fm_reference(x: torch.Tensor, bank: torch.Tensor,
                                    bn_p: Mapping[str, torch.Tensor],
                                    bn_s: Mapping[str, torch.Tensor]
                                    ) -> torch.Tensor:
    """The plain version: (B, L) -> (24, B, (L - 128) // 3)."""
    return fused_frontend_dot_bm_reference(x, bank, bn_p, bn_s).permute(
        1, 0, 2).contiguous()


def _launch(name: str, x: torch.Tensor, bank: torch.Tensor, bn_p, bn_s,
            batch_major: bool) -> torch.Tensor:
    b, length, c, sc = fe.check_args(name, x, bank, bn_p, bn_s,
                                     dtypes=(torch.bfloat16,), max_rows=ROWS)
    t_out = (length - (fe.KSIZE - 1)) // 3

    from aasist_tpu_torch.ops import _build
    lib = _build.load("frontend_dot").lib
    fn = lib.aasist_frontend_dot_bm if batch_major else \
        lib.aasist_frontend_dot_fm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shape = (b, ROWS, t_out) if batch_major else (ROWS, b, t_out)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), bank.data_ptr(), sc.data_ptr(),
                 out.data_ptr(), b, length, c, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
    return out


def fused_frontend_dot_fm(x: torch.Tensor, bank: torch.Tensor,
                          bn_p: Mapping[str, torch.Tensor],
                          bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, L) waveform -> the frontend, filter-major: (24, B, (L - 128) // 3)
    in ``x``'s dtype.  Arguments as ``ops.fused_frontend.fused_frontend``;
    ``bank`` may carry freq-aug masking.  bfloat16 on CUDA (float32 raises
    ``TypeError``).  Every launch adds one to
    ``fused_frontend_dot_fm.launches``."""
    if x.device.type == "cpu":
        return fused_frontend_dot_fm_reference(x, bank, bn_p, bn_s)
    out = _launch("fused_frontend_dot_fm", x, bank, bn_p, bn_s, False)
    fused_frontend_dot_fm.launches += 1
    return out


def fused_frontend_dot_bm(x: torch.Tensor, bank: torch.Tensor,
                          bn_p: Mapping[str, torch.Tensor],
                          bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, L) waveform -> the frontend, batch-major: (B, 24, (L - 128) // 3)
    in ``x``'s dtype; ``out[:, None, :C // 3]`` is ``fused_frontend``'s
    output as a strided view.  Arguments and types as
    ``fused_frontend_dot_fm``.  Every launch adds one to
    ``fused_frontend_dot_bm.launches``."""
    if x.device.type == "cpu":
        return fused_frontend_dot_bm_reference(x, bank, bn_p, bn_s)
    out = _launch("fused_frontend_dot_bm", x, bank, bn_p, bn_s, True)
    fused_frontend_dot_bm.launches += 1
    return out


fused_frontend_dot_fm.launches = 0
fused_frontend_dot_bm.launches = 0
