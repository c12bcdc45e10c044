"""The step-cost probe's kernels (``csrc/stepcost.cu``): empty, copy and
matrix kernels over block 0's grid geometry.

Counterpart of ``tools/probe_stepcost.py:make_runner``.  x is (32, B, 32, T)
bf16 (channel, batch, row, time), w (96, 64) bf16, and the grid is (B / g,
T / u) steps of g batch rows by u times; one step is one CTA.  The modes,
with the probe's output layouts letter for letter:

    nop     1.0                        (32, B, 23, T)
    nopF32  1.0                        (32, B, 32, T)
    nopblk  1.0                        (B/g, T/u, 32, g, 32, u), step-blocked
    copy    x[:, :, :23]               (32, B, 23, T)
    matmul  d = w^T [x rows r, r+1, r+2] in f32, out[o, b, r, t] =
            d[o, r] + d[32 + o, r + 1] for r < 23, rounded once
                                       (32, B, 23, T)
    matblk  the same for r < 24, rows 24..31 zero
                                       (B/g, T/u, 32, g, 32, u)

    stepcost(mode, x, w, g, u, out=None)
    stepcost_older(mode, x, w, g, u, out=None)

``stepcost`` stores the nop modes' and copy's outputs with TMA (the source's
header says how); ``stepcost_older`` launches the ``STEPCOST_OLDER`` build,
whose nop modes and copy are the kernels those replaced, and which the TMA
build is timed against (matmul and matblk are one kernel in both).  TMA
needs x and out 16-byte aligned, every global stride a multiple of 16 bytes
(T % 8 == 0) and a box's rows too (u % 8 == 0): the wrappers raise
``ValueError`` on anything else before any launch.

The plain version, ``stepcost_reference``, needs no g or u but for the
step-blocked layouts.  ``out``, when given, is written in place (a check can
fill it with NaN first, so that an element the kernel misses shows).  The
wrappers launch their kernel for CUDA tensors and raise on anything it does
not take; CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

MODES = ("nop", "nopF32", "nopblk", "copy", "matmul", "matblk")
CHANNELS = 32          # C_IN = C_OUT
ROWS = 32              # rows of x and of the padded layouts
F = 23                 # rows of the (32, B, 23, T) outputs
K, M = 3 * CHANNELS, 2 * CHANNELS
TMA_MODES = MODES[:4]  # the modes whose kernels the two builds differ in
OLDER_DEFINES = {"STEPCOST_OLDER": None}


def out_shape(mode: str, b: int, t: int, g: int, u: int
              ) -> Tuple[int, ...]:
    """The probe's output shape of ``mode`` at (B, T) in steps of (g, u)."""
    _check_mode(mode)
    if mode == "nopF32":
        return (CHANNELS, b, ROWS, t)
    if mode in ("nopblk", "matblk"):
        return (b // g, t // u, CHANNELS, g, ROWS, u)
    return (CHANNELS, b, F, t)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"stepcost: {mode!r} is not one of {MODES}")


def _check_geometry(b: int, t: int, g: int, u: int) -> None:
    if min(b, t, g, u) < 1 or b % g or t % u:
        raise ValueError(f"stepcost: steps (g, u) = ({g}, {u}) do not tile "
                         f"(B, T) = ({b}, {t})")


def _blocked(y: torch.Tensor, g: int, u: int) -> torch.Tensor:
    """(32, B, 32, T) -> the step-blocked (B/g, T/u, 32, g, 32, u)."""
    c, b, r, t = y.shape
    return y.reshape(c, b // g, g, r, t // u, u).permute(
        1, 4, 0, 2, 3, 5).contiguous()


def _dots(x: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    """out rows 0 .. rows - 1 of matmul's function, (32, B, rows, T) in
    bf16: the f32 sums over the three row shifts of both halves, added and
    rounded once.  A slice of the batch at a time, for memory."""
    wf = w.float()
    parts = []
    for xs in x.split(16, dim=1):
        a = torch.cat([xs[:, :, s:s + rows + 1] for s in range(3)]).float()
        d = torch.einsum("km,kbrt->mbrt", wf, a)     # (64, b, rows + 1, T)
        parts.append((d[:CHANNELS, :, :rows] + d[CHANNELS:, :, 1:rows + 1]
                      ).to(x.dtype))
    return torch.cat(parts, dim=1)


def stepcost_reference(mode: str, x: torch.Tensor, w: torch.Tensor, g: int,
                       u: int) -> torch.Tensor:
    """The plain version of ``stepcost``: a ``torch.full``, a slice, or the
    f32 ``einsum`` over the three row shifts and the halves' sum, rounded
    once; the step-blocked layouts by a permute."""
    _check_mode(mode)
    _, b, _, t = x.shape
    _check_geometry(b, t, g, u)
    if mode.startswith("nop"):
        return torch.full(out_shape(mode, b, t, g, u), 1.0, dtype=x.dtype,
                          device=x.device)
    if mode == "copy":
        return x[:, :, :F].contiguous()
    if mode == "matmul":
        return _dots(x, w, F)
    y = torch.nn.functional.pad(_dots(x, w, F + 1), (0, 0, 0, ROWS - F - 1))
    return _blocked(y, g, u)


def _check(x: torch.Tensor, w: torch.Tensor,
           out: Optional[torch.Tensor]) -> None:
    for name, t in (("x", x), ("w", w), ("out", out)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"stepcost: unsupported device {t.device} for "
                             f"{name}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"stepcost: {name} is {t.dtype}; the kernels "
                            "take bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"stepcost: {name} must be contiguous and "
                             "16-byte aligned")
    if x.dim() != 4 or (x.shape[0], x.shape[2]) != (CHANNELS, ROWS):
        raise ValueError(f"stepcost: x must be (32, B, 32, T), got "
                         f"{tuple(x.shape)}")
    if tuple(w.shape) != (K, M):
        raise ValueError(f"stepcost: w must be ({K}, {M}), got "
                         f"{tuple(w.shape)}")


def _launch(name: str, defines, mode: str, x: torch.Tensor,
            w: torch.Tensor, g: int, u: int,
            out: Optional[torch.Tensor]) -> torch.Tensor:
    """Check a CUDA call of ``csrc/stepcost.cu``'s build ``defines`` and
    launch it; ``name`` heads the messages."""
    _check(x, w, out)
    b, t = x.shape[1], x.shape[3]
    _check_geometry(b, t, g, u)
    shape = out_shape(mode, b, t, g, u)
    if out is not None and tuple(out.shape) != shape:
        raise ValueError(f"{name}: out must be {shape}, got "
                         f"{tuple(out.shape)}")
    if (2 * t) % 16:
        raise ValueError(f"{name}: T = {t} makes a row stride of {2 * t} "
                         "bytes, no multiple of 16 (TMA)")
    if u % 8:
        raise ValueError(f"{name}: u = {u} is no multiple of 8")
    if t // u > 65535:
        raise ValueError(f"{name}: {t // u} steps along T exceed the "
                         "grid's 65535")
    from aasist_tpu_torch.ops import _build
    fn = _build.load("stepcost", defines).lib.aasist_stepcost
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 MODES.index(mode), b, t, g, u,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t "
                           f"{err})")
    return out


def stepcost(mode: str, x: torch.Tensor, w: torch.Tensor, g: int, u: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mode``'s function of x (32, B, 32, T) and w (96, 64), bf16, over
    steps of (g, u) (the module's header): a new tensor, or ``out`` written
    in place.  u must be a multiple of 8 (rows start on 16-byte boundaries).
    Every launch adds one to ``stepcost.launches``."""
    _check_mode(mode)
    if x.device.type == "cpu":
        ref = stepcost_reference(mode, x, w, g, u)
        return ref if out is None else out.copy_(ref)
    out = _launch("stepcost", None, mode, x, w, g, u, out)
    stepcost.launches += 1
    return out


def stepcost_older(mode: str, x: torch.Tensor, w: torch.Tensor, g: int,
                   u: int, out: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """``stepcost`` through the ``STEPCOST_OLDER`` build (the nop modes and
    copy on the kernels the TMA ones replaced); the same arguments, guards
    and result.  Every launch adds one to ``stepcost_older.launches``."""
    _check_mode(mode)
    if x.device.type == "cpu":
        ref = stepcost_reference(mode, x, w, g, u)
        return ref if out is None else out.copy_(ref)
    out = _launch("stepcost_older", OLDER_DEFINES, mode, x, w, g, u, out)
    stepcost_older.launches += 1
    return out


stepcost.launches = 0
stepcost_older.launches = 0
