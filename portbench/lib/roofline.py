"""The yardstick's peaks and bounds, kept with the benchmark.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores
(the configuration's float32 runs with TF32 off), 494.5 TFLOP/s TF32,
1,979 TFLOP/s fp8, 3.35 TB/s of HBM.

``frontend_bound`` is a copy of ``aasist_tpu_torch/tools/_common.py:
frontend_bound`` (its unpadded store): the least time one sinc-frontend
call can take, the larger of the conv's FLOPs over the peak for the type
and the bytes read and written once over the memory rate.  It counts the
function's work, whatever kernel computes it.
"""

from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 494.5e12,
              "float8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12
ESIZE = {"bfloat16": 2, "float32": 4, "float8": 1}
TAPS = 129


def frontend_bound(b: int, length: int, c: int, dtype: str
                   ) -> Tuple[float, str]:
    """(least ms, what bounds it) of the sinc frontend (conv C x 129,
    |.|, max pool (3, 3), BatchNorm, SELU) on a (b, length) batch."""
    f_out, t_out = c // 3, (length - (TAPS - 1)) // 3
    flops = 2.0 * b * (3 * f_out) * (3 * t_out) * TAPS
    nbytes = ESIZE[dtype] * (b * length + c * TAPS + b * f_out * t_out) + 16
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
