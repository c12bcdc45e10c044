"""The tail of residual block 0 as kernels of their own
(``csrc/tail_constructs.cu``): the max pool (1,3) over time in three
formulations, and SELU fused with the change to NCHW.

Counterparts of the kernels of ``tools/probe_tail_constructs.py``:

    pool3_time(y, how)        (B, C, F, T) -> (B, C, F, T // 3)
        ``pool_reshape`` / ``pool_strided``.  ``how`` is "direct" (each
        thread reads its three neighbours from device memory) or "staged" (a
        tile of the row goes through shared memory in 16-byte loads): what
        the two spellings of a stride-3 lane access are on the TPU is, on
        the card, the choice of how a memory-bound pass reads its input.
    pool3_time_major(y)       (B, C, T, F) -> (B, C, T // 3, F)
        ``pool_sublane``: the pool over the slower axis of a time-major
        tensor.
    selu_to_nchw(z, how)      (C, F1, B, T) -> (B, C, F1, T)
        ``geg_write``: SELU (f32 inside) and the change from the compute
        layout to NCHW.  Time is innermost on both sides, so the kernel moves
        whole rows with coalesced reads and writes.  ``how`` is "vector" (a
        thread moves 16 bytes; T must be a multiple of that many elements)
        or "staged" (a chunk of a row goes through shared memory; any T);
        None takes "vector" where T allows it.

Any sizes; the TPU kernels' tile sizes (G, V, U) have no counterpart.  The
pools floor: the last ``T % 3`` times are dropped, as ``F.max_pool2d`` drops
them.  float32 and bfloat16.  Each wrapper launches its kernel for CUDA
tensors and raises on anything it does not take; CPU tensors take the plain
versions (``*_reference``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from aasist_tpu_torch.ops import fused_frontend as fe

POOL_HOW = ("direct", "staged")
SELU_HOW = ("vector", "staged")


def pool3_time_reference(y: torch.Tensor, how: str = "direct"
                         ) -> torch.Tensor:
    """The plain version: ``F.max_pool2d(y, (1, 3))``, whatever ``how``."""
    _check_how(how)
    return F.max_pool2d(y, (1, 3))


def pool3_time_major_reference(y: torch.Tensor) -> torch.Tensor:
    """The plain version: the max over reshaped time triples."""
    b, c, t, f = y.shape
    return y[:, :, :3 * (t // 3)].reshape(b, c, t // 3, 3, f).amax(3)


def selu_to_nchw_reference(z: torch.Tensor) -> torch.Tensor:
    """The plain version: SELU in f32, rounded to ``z``'s type, permuted."""
    return F.selu(z.float()).to(z.dtype).permute(2, 0, 1, 3).contiguous()


def _check_how(how: str) -> None:
    if how not in POOL_HOW:
        raise ValueError(f"pool3_time: {how!r} is not one of {POOL_HOW}")


def _check(name: str, t: torch.Tensor, layout: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in fe._DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32 or "
                        "bfloat16)")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {layout} tensor, "
                         f"got {tuple(t.shape)}")


def _call(name: str, entry: str, argtypes, out: torch.Tensor, *args) -> None:
    from aasist_tpu_torch.ops import _build
    fn = getattr(_build.load("tail_constructs").lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(out.device):
        err = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")


def pool3_time(y: torch.Tensor, how: str = "direct") -> torch.Tensor:
    """Max pool (1,3) over the last axis: (B, C, F, T) -> (B, C, F, T // 3),
    in ``y``'s dtype; ``how`` picks the formulation (the module's header).
    Every launch adds one to ``pool3_time.launches``."""
    _check_how(how)
    if y.device.type == "cpu":
        return pool3_time_reference(y, how)
    _check("pool3_time", y, "(B, C, F, T)")
    b, c, f, t = y.shape
    if min(b, c, f) < 1 or t < 3:
        raise ValueError(f"pool3_time: unsupported shape {tuple(y.shape)}")
    if how == "staged" and y.data_ptr() % 16:
        raise ValueError("pool3_time: the staged formulation needs a "
                         "16-byte aligned tensor")
    out = torch.empty((b, c, f, t // 3), dtype=y.dtype, device=y.device)
    _call("pool3_time", "aasist_pool3_time",
          [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3
          + [ctypes.c_void_p], out,
          y.data_ptr(), out.data_ptr(), b * c * f, t, int(how == "staged"),
          fe._DTYPES[y.dtype])
    pool3_time.launches += 1
    return out


def pool3_time_major(y: torch.Tensor) -> torch.Tensor:
    """Max pool over time of a time-major tensor: (B, C, T, F) ->
    (B, C, T // 3, F), in ``y``'s dtype.  Every launch adds one to
    ``pool3_time_major.launches``."""
    if y.device.type == "cpu":
        return pool3_time_major_reference(y)
    _check("pool3_time_major", y, "(B, C, T, F)")
    b, c, t, f = y.shape
    if min(b, c, f) < 1 or t < 3:
        raise ValueError(f"pool3_time_major: unsupported shape "
                         f"{tuple(y.shape)}")
    out = torch.empty((b, c, t // 3, f), dtype=y.dtype, device=y.device)
    _call("pool3_time_major", "aasist_pool3_time_major",
          [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3
          + [ctypes.c_void_p], out,
          y.data_ptr(), out.data_ptr(), b * c, t, f, fe._DTYPES[y.dtype])
    pool3_time_major.launches += 1
    return out


def selu_to_nchw(z: torch.Tensor, how: Optional[str] = None
                 ) -> torch.Tensor:
    """SELU and the layout change (C, F1, B, T) -> (B, C, F1, T), in ``z``'s
    dtype; ``how`` picks the formulation (the module's header).  Every
    launch adds one to ``selu_to_nchw.launches``."""
    if how is not None and how not in SELU_HOW:
        raise ValueError(f"selu_to_nchw: {how!r} is not one of {SELU_HOW}")
    if z.device.type == "cpu":
        return selu_to_nchw_reference(z)
    _check("selu_to_nchw", z, "(C, F1, B, T)")
    c, f1, b, t = z.shape
    if min(c, f1, b, t) < 1 or c * f1 >= 2 ** 31:
        raise ValueError(f"selu_to_nchw: unsupported shape {tuple(z.shape)}")
    if z.data_ptr() % 16:
        raise ValueError("selu_to_nchw: needs a 16-byte aligned tensor")
    ragged = t % (4 if z.dtype == torch.float32 else 8) != 0
    if how == "vector" and ragged:
        raise ValueError(f"selu_to_nchw: T = {t} is no multiple of a "
                         "16-byte vector, which \"vector\" needs")
    staged = ragged if how is None else how == "staged"
    out = torch.empty((b, c, f1, t), dtype=z.dtype, device=z.device)
    _call("selu_to_nchw", "aasist_selu_to_nchw",
          [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
          out, z.data_ptr(), out.data_ptr(), c, f1, b, t, int(staged),
          fe._DTYPES[z.dtype])
    selu_to_nchw.launches += 1
    return out


pool3_time.launches = 0
pool3_time_major.launches = 0
selu_to_nchw.launches = 0
