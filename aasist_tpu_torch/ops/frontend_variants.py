"""The fused sinc frontend computed on the tensor cores, in four store
layouts (``csrc/frontend_dot_wg.cu`` on ``wgmma``, ``csrc/frontend_dot.cu``
on ``mma.sync``).

Counterpart of the two dot formulations of the TPU frontend,
``tools/probe_frontend_variants.py:run_v2`` (filter-major store) and
``tools/probe_fe_fix.py:run_v2bm`` (batch-major store, which block 0's conv
reads without a transpose), and, through the same kernels' other stores, of
the Scorer's frontend (``aasist_tpu/ops/fused_frontend.py:_run``) and of the
padded frontend of the frontend + block-0 pair
(``tools/fused_stack.py:_fe_run``).
All compute ``ops.fused_frontend``'s function, sinc conv (C x 129) -> |.|
-> max pool (3,3) -> eval BatchNorm(1) -> SELU, and store it as

    fused_frontend_dot_fm(x, bank, bn_p, bn_s)      -> (24, B, T)
    fused_frontend_dot_bm(x, bank, bn_p, bn_s)      -> (B, 24, T)
    fused_frontend_dot_plain(x, bank, bn_p, bn_s)   -> (B, 1, C // 3, T)
    fused_frontend_dot_padded(x, bank, bn_p, bn_s)  -> (B, C // 3 + 2, T + 2)

with T = (L - 128) // 3.  The first two launch ``csrc/frontend_dot_wg.cu``
(``SOURCE``), their ``_older`` twins ``fused_frontend_dot_fm_older`` and
``fused_frontend_dot_bm_older`` the kernel before it,
``csrc/frontend_dot.cu`` (``OLDER_SOURCE``), which the last two, the bf16
Scorer's routes, keep.  In the first two, rows 0 .. C // 3 - 1 are the
frontend's output and the rows above them zero (row 23 for the 70-filter
bank); the last is the zero-bordered frame that block 0 reads.  The TPU
probes store n_tiles * u columns; the columns past T are their tile padding
and no part of the function.  Their host-side phase split (``make_xt``) and
the G / u block sizes have no counterpart: the kernel reads the waveform
directly.

The kernels are bfloat16 only: bf16 operands on the tensor cores, f32
accumulation, one rounding at the store, as the TPU kernels compute (the
``wgmma`` kernel takes SELU's exponential from ``__expf``, the older one
from ``expm1f``: a bf16 ulp apart at most, which ``chip_smoke.py`` gates).
They cannot compute the float32 function: their products are of bf16
operands, so a float32 input would be rounded first and miss the f32 gate
(2e-4) of the Scorer's f32 path, which keeps the CUDA-core kernel of
``ops/fused_frontend.py`` instead.  A float32 CUDA tensor raises
``TypeError``; it is never handed to another kernel or to the plain
version.  CPU tensors of either type take the plain versions
(``*_reference``).
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Tuple

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


SOURCE = "frontend_dot_wg"          # fused_frontend_dot_{fm,bm}'s kernel
OLDER_SOURCE = "frontend_dot"       # the _older ones', the Scorer's routes'

# Pooled columns of one work item of either source (TILE in
# csrc/frontend_dot_wg.cu, 16 SUB WARPS in csrc/frontend_dot.cu).
DOT_TILE = 128


def dot_work(b: int, length: int) -> Tuple[int, int]:
    """The kernel's work decomposition for a (b, length) waveform:
    (n_tiles, n_work).  Item w covers batch row w // n_tiles and pooled
    columns [(w % n_tiles) * DOT_TILE, + DOT_TILE) clipped to T."""
    t_out = (length - (fe.KSIZE - 1)) // 3
    n_tiles = -(-t_out // DOT_TILE)
    return n_tiles, b * n_tiles


def dot_items(b: int, length: int):
    """Every work item of ``dot_work`` as (batch row, first column, end
    column): the columns each item stores."""
    t_out = (length - (fe.KSIZE - 1)) // 3
    n_tiles, n_work = dot_work(b, length)
    for w in range(n_work):
        t0 = (w % n_tiles) * DOT_TILE
        yield w // n_tiles, t0, min(t0 + DOT_TILE, t_out)


_LAYOUTS = ("fm", "bm", "plain", "padded")


def _launch(name: str, x: torch.Tensor, bank: torch.Tensor, bn_p, bn_s,
            layout: str, source: str = SOURCE,
            defines: Optional[Mapping[str, object]] = None) -> torch.Tensor:
    """Check a CUDA call and launch ``source``'s kernel (``SOURCE`` or
    ``OLDER_SOURCE``) with the store ``layout`` (one of ``_LAYOUTS``);
    ``defines`` picks a compile-time build of it (see its header; only the
    probe passes any), ``name`` heads the messages.  No launch is counted
    here."""
    if source not in (SOURCE, OLDER_SOURCE) or layout not in _LAYOUTS:
        raise ValueError(f"{name}: unknown source {source!r} or layout "
                         f"{layout!r}")
    b, length, c, sc = fe.check_args(name, x, bank, bn_p, bn_s,
                                     dtypes=(torch.bfloat16,), max_rows=ROWS)
    t_out = (length - (fe.KSIZE - 1)) // 3
    f_out = c // 3
    n_tiles, n_work = dot_work(b, length)
    if n_work >= 2 ** 31:
        raise ValueError(f"{name}: {n_work} work items exceed the kernel's "
                         "int range")

    from aasist_tpu_torch.ops import _build
    fn = getattr(_build.load(source, defines).lib,
                 f"aasist_{source}_{layout}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shape = {"fm": (ROWS, b, t_out), "bm": (b, ROWS, t_out),
             "plain": (b, 1, f_out, t_out),
             "padded": (b, f_out + 2, t_out + 2)}[layout]
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), bank.data_ptr(), sc.data_ptr(),
                 out.data_ptr(), b, length, c, n_tiles, n_work, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
    return out


def fused_frontend_dot_fm(x: torch.Tensor, bank: torch.Tensor,
                          bn_p: Mapping[str, torch.Tensor],
                          bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, L) waveform -> the frontend, filter-major: (24, B, (L - 128) // 3)
    in ``x``'s dtype, on ``wgmma`` (``csrc/frontend_dot_wg.cu``).
    Arguments as ``ops.fused_frontend.fused_frontend``; ``bank`` may carry
    freq-aug masking.  bfloat16 on CUDA (float32 raises ``TypeError``).
    Every launch adds one to ``fused_frontend_dot_fm.launches``."""
    if x.device.type == "cpu":
        return fused_frontend_dot_fm_reference(x, bank, bn_p, bn_s)
    out = _launch("fused_frontend_dot_fm", x, bank, bn_p, bn_s, "fm")
    fused_frontend_dot_fm.launches += 1
    return out


def fused_frontend_dot_bm(x: torch.Tensor, bank: torch.Tensor,
                          bn_p: Mapping[str, torch.Tensor],
                          bn_s: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """(B, L) waveform -> the frontend, batch-major: (B, 24, (L - 128) // 3)
    in ``x``'s dtype; ``out[:, None, :C // 3]`` is ``fused_frontend``'s
    output as a strided view.  Kernel, arguments and types as
    ``fused_frontend_dot_fm``.  Every launch adds one to
    ``fused_frontend_dot_bm.launches``."""
    if x.device.type == "cpu":
        return fused_frontend_dot_bm_reference(x, bank, bn_p, bn_s)
    out = _launch("fused_frontend_dot_bm", x, bank, bn_p, bn_s, "bm")
    fused_frontend_dot_bm.launches += 1
    return out


def fused_frontend_dot_fm_older(x: torch.Tensor, bank: torch.Tensor,
                                bn_p: Mapping[str, torch.Tensor],
                                bn_s: Mapping[str, torch.Tensor]
                                ) -> torch.Tensor:
    """``fused_frontend_dot_fm`` on the kernel before it, ``mma.sync``
    (``csrc/frontend_dot.cu``): the same function, output and guards.
    Every launch adds one to ``fused_frontend_dot_fm_older.launches``."""
    if x.device.type == "cpu":
        return fused_frontend_dot_fm_reference(x, bank, bn_p, bn_s)
    out = _launch("fused_frontend_dot_fm_older", x, bank, bn_p, bn_s, "fm",
                  OLDER_SOURCE)
    fused_frontend_dot_fm_older.launches += 1
    return out


def fused_frontend_dot_bm_older(x: torch.Tensor, bank: torch.Tensor,
                                bn_p: Mapping[str, torch.Tensor],
                                bn_s: Mapping[str, torch.Tensor]
                                ) -> torch.Tensor:
    """``fused_frontend_dot_bm`` on ``csrc/frontend_dot.cu``, as
    ``fused_frontend_dot_fm_older``.  Every launch adds one to
    ``fused_frontend_dot_bm_older.launches``."""
    if x.device.type == "cpu":
        return fused_frontend_dot_bm_reference(x, bank, bn_p, bn_s)
    out = _launch("fused_frontend_dot_bm_older", x, bank, bn_p, bn_s, "bm",
                  OLDER_SOURCE)
    fused_frontend_dot_bm_older.launches += 1
    return out


def fused_frontend_dot_plain(x: torch.Tensor, bank: torch.Tensor,
                             bn_p: Mapping[str, torch.Tensor],
                             bn_s: Mapping[str, torch.Tensor]
                             ) -> torch.Tensor:
    """(B, L) waveform -> the frontend in the Scorer's layout,
    (B, 1, C // 3, (L - 128) // 3), in ``x``'s dtype: the bf16 route of
    ``ops.fused_frontend.fused_frontend``, on ``csrc/frontend_dot.cu``.
    Arguments and types as ``fused_frontend_dot_fm``.  Every launch adds
    one to ``fused_frontend_dot_plain.launches``."""
    if x.device.type == "cpu":
        return fe.fused_frontend_reference(x, bank, bn_p, bn_s)
    out = _launch("fused_frontend_dot_plain", x, bank, bn_p, bn_s, "plain",
                  OLDER_SOURCE)
    fused_frontend_dot_plain.launches += 1
    return out


def fused_frontend_dot_padded_reference(x: torch.Tensor, bank: torch.Tensor,
                                        bn_p: Mapping[str, torch.Tensor],
                                        bn_s: Mapping[str, torch.Tensor]
                                        ) -> torch.Tensor:
    """The plain version: (B, L) -> (B, C // 3 + 2, (L - 128) // 3 + 2),
    the frontend's output with a zero border of one row and one column."""
    return F.pad(fe.fused_frontend_reference(x, bank, bn_p, bn_s)[:, 0],
                 (1, 1, 1, 1))


def fused_frontend_dot_padded(x: torch.Tensor, bank: torch.Tensor,
                              bn_p: Mapping[str, torch.Tensor],
                              bn_s: Mapping[str, torch.Tensor]
                              ) -> torch.Tensor:
    """(B, L) waveform -> the frontend inside the zero-bordered
    (B, C // 3 + 2, (L - 128) // 3 + 2) frame that block 0 reads, in
    ``x``'s dtype: the bf16 route of
    ``ops.fused_stack.fused_frontend_padded``, on ``csrc/frontend_dot.cu``.
    Arguments and types as ``fused_frontend_dot_fm``.  Every launch adds one
    to ``fused_frontend_dot_padded.launches``."""
    if x.device.type == "cpu":
        return fused_frontend_dot_padded_reference(x, bank, bn_p, bn_s)
    out = _launch("fused_frontend_dot_padded", x, bank, bn_p, bn_s,
                  "padded", OLDER_SOURCE)
    fused_frontend_dot_padded.launches += 1
    return out


fused_frontend_dot_fm.launches = 0
fused_frontend_dot_bm.launches = 0
fused_frontend_dot_fm_older.launches = 0
fused_frontend_dot_bm_older.launches = 0
fused_frontend_dot_plain.launches = 0
fused_frontend_dot_padded.launches = 0
