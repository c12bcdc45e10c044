"""What the on-card tools share: the card's line, CUDA-event timing, the
kernels' bounds, and the pretrained AASIST's frontend and block 0."""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]

# H100 SXM data-sheet peaks (dense), for the kernels' bounds
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
BLOCK0_CHANNELS = 32

# Per-element gate for the bf16 head's y1 against conv1 + bn2 + SELU
# computed in float32 from the kernel's own stored x0.  The kernel does the
# same f32 sums on the same bf16 values and rounds once, so the two differ
# by half a bf16 ulp (2^-9 relative) plus f32 summation order and __expf:
# 2^-7 relative leaves a factor of four, and 1e-2 absolute covers SELU's
# zero crossing, where a value is the difference of larger terms.
HEAD_Y1_OWN_X0_TOL = dict(atol=1e-2, rtol=2.0 ** -7)


def need_card(tool: str) -> None:
    """Exit non-zero unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: needs a CUDA card")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _esize(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def frontend_bound(b: int, length: int, c: int, dtype: str,
                   padded: bool = False, rows: Optional[int] = None
                   ) -> Tuple[float, str]:
    """(least ms, what bounds it) for one fused-frontend call: the conv's
    FLOPs over the peak for the type, or the bytes read and written once
    over the memory rate, whichever is larger.  ``padded``: the output is
    the zero-bordered frame; ``rows``: it is stored in that many rows."""
    f_out, t_out = c // 3, (length - 128) // 3
    flops = 2.0 * b * (3 * f_out) * (3 * t_out) * 129
    n_out = ((f_out + 2) * (t_out + 2) if padded
             else (rows or f_out) * t_out)
    nbytes = _esize(dtype) * (b * length + c * 129 + b * n_out) + 16
    return _bound(flops, nbytes, dtype)


def block0_bound(b: int, length: int, c: int, dtype: str
                 ) -> Tuple[float, str]:
    """(least ms, what bounds it) for one fused_block0 call on the frame of
    a (b, length) waveform: conv1 at the F + 1 y1 rows and the conv2 and
    downsample taps at the 3 * T_out positions the pool keeps, over the peak
    for the type, or the frame read and the output written once over the
    memory rate, whichever is larger."""
    f, t_z = 23, (length - 128) // 3
    t_out = t_z // 3
    flops = 2.0 * b * (c * 6 * (f + 1) * min(3 * t_out + 1, t_z)
                       + (c * c * 6 + c * 3) * f * 3 * t_out)
    nbytes = (_esize(dtype) * (b * (f + 2) * (t_z + 2) + b * c * f * t_out)
              + 4 * (c * 6 + c + c * c * 6 + c * 3 + c))
    return _bound(flops, nbytes, dtype)


def head_bound(b: int, length: int, c: int, dtype: str
               ) -> Tuple[float, str]:
    """(least ms, what bounds it) for one fused_frontend_head call: the
    frontend's conv and conv1 at the (F + 1) x T y1 positions over the peak
    for the type, or the waveform, bank and folded taps read and the 32 + 1
    planes of F + 1 rows written once over the memory rate, whichever is
    larger."""
    f_out, t_out = c // 3, (length - 128) // 3
    ch = BLOCK0_CHANNELS
    flops = 2.0 * b * ((3 * f_out) * (3 * t_out) * 129
                       + ch * 6 * (f_out + 1) * t_out)
    nbytes = (_esize(dtype) * (b * length + c * 129
                               + b * (ch + 1) * (f_out + 1) * t_out)
              + 4 * (ch * 7) + 16)
    return _bound(flops, nbytes, dtype)


def head_y1_excess(y1, x0, block, atol: float, rtol: float) -> float:
    """max over elements of |y1 - ref| / (atol + rtol |ref|), where ref is
    ``block``'s conv1, bn2 and SELU in float32 on the stored frame ``x0``
    (B, F + 1, T): at most 1 where ``allclose`` would hold.  A slice of the
    batch at a time, for memory."""
    import copy

    import torch
    import torch.nn.functional as F

    b32 = copy.deepcopy(block).float()
    worst = 0.0
    with torch.inference_mode():
        for ys, xs in zip(y1.split(16), x0.split(16)):
            ref = F.conv2d(xs[:, None, :-1].float(), b32.conv1.weight,
                           b32.conv1.bias, padding=(1, 1))
            ref = F.selu(F.batch_norm(
                ref, b32.bn2.running_mean, b32.bn2.running_var,
                b32.bn2.weight, b32.bn2.bias, training=False,
                eps=b32.bn2.eps))
            worst = max(worst, ((ys.float() - ref).abs()
                                / (atol + rtol * ref.abs())).max().item())
    return worst


def pretrained(dtype):
    """(model, bank, bn_p, bn_s) of the pretrained AASIST on the card in
    ``dtype``: the arguments the frontend kernels take; block 0 is
    ``model.encoder[0]``."""
    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.weights import load_npz

    cfg = load_config(ROOT / "configs" / "AASIST.conf")
    model = load_npz(build_model(cfg.model_config), ROOT / cfg.model_path)
    model = model.to("cuda", dtype).eval()
    bn = model.first_bn
    return (model, model.filterbank.detach().contiguous(),
            {"weight": bn.weight.detach(), "bias": bn.bias.detach()},
            {"mean": bn.running_mean, "var": bn.running_var})
