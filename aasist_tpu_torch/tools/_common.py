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

# Gates of the bf16 block-0 variants (``ops.block0_variants``) against plain
# versions that repeat each kernel's rounding sequence, on
# rel_err = max|kernel - plain| / max|plain|.  One ulp of the largest
# outputs is 2^-8 to 2^-7 of max|plain|, so the readings come in steps.
#   Sets with the default kernel's values keep block 0's bf16 gate.
#   The bf16 epilogues round y1 op by op on both sides and differ where an
# f32 sum lies on a rounding boundary or h2exp's last bit differs from
# exp's: one output ulp, read as 2.4e-3 to 3.2e-3.  The f32 epilogue is two
# ulps from them (5.6e-3 to 7.5e-3), so the gate, 5e-3, lies between.  The
# largest error comes in such steps, the mean error does not: a kernel must
# also be nearer in mean_err = mean|kernel - plain| / mean|plain| to its
# own plain version (read: 4.0e-7 to 4.9e-7) than to ``base``'s (3.2e-3 to
# 3.4e-3).  One conv1 tap zeroed reads 0.40 to 0.49 on rel_err.
#   Stages dma .. epi store f32 sums of up to 18 terms rounded once: at most
# an ulp of the largest output apart (read: 0 to 4.7e-3), gate 1e-2.  An ulp
# of the largest output hides a dropped bias (0.3 at 51), so they are also
# gated on mean_err, where the rare one-ulp flips of a sound kernel vanish
# (read: 0 to 8.0e-8) and a fault in every element does not: the
# downsample's bias zeroed reads 0.25 (``conv1``) and 7.5e-2 (``epi``), one
# frame row of 25 zeroed at least 8.8e-3 (``dma``) and 7.5e-3 (``fill``).
# The gate, 1e-4, is a thousand sound readings and a seventy-fifth of the
# least fault.
# (Readings: NVIDIA H100 80GB HBM3, 700.00 W; the probes print them.)
B0_SAME_VALUES = ("none", "rmw", "b2slice", "base", "vB", "vD", "conv2",
                  "full")
B0_BF16_EPILOGUES = ("bf16epi", "all", "vA", "vF")
B0_CHECKED_STAGES = ("dma", "fill", "conv1", "epi")
B0_GATE_SAME_VALUES = 2e-2
B0_GATE_BF16_EPILOGUE = 5e-3
B0_GATE_STAGE = 1e-2
B0_GATE_STAGE_MEAN = 1e-4
B0_FAULT_FACTOR = 5     # a planted fault must read this many gates


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


def stage_bound(stage: str, b: int, length: int, c: int, dtype: str
                ) -> Tuple[float, str]:
    """(least ms, what bounds it) for one call of block 0 cut after ``stage``
    (``ops.block0_variants.STAGES``) on the frame of a (b, length) waveform.
    Every stage reads the frame and writes the (b, c, F, T_out) output once;
    the operations are those its function needs and no more:

      dma    none;
      fill   18 additions an output of channel 0;
      conv1  conv1 and the downsample at the F rows and 3 T_out times summed;
      epi    conv1 at the two times of each y1 row a pooled column reads,
             the downsample at one;
      conv2  conv1 at the F + 1 y1 rows, the downsample, and 14 of conv2's
             18 (pool phase, tap) pairs at the 3 T_out positions the pool
             keeps;
      full   the same with all 18: block 0.

    The larger of the operations over the peak for the type and the bytes
    over the memory rate."""
    f, t_z = 23, (length - 128) // 3
    t_out = t_z // 3
    y1 = c * 6 * (f + 1) * min(3 * t_out + 1, t_z)       # multiply-adds
    ds = c * 3 * f * 3 * t_out
    conv2 = c * c * 6 * f * 3 * t_out
    flops = 2.0 * b * {
        "dma": 0,
        "fill": 9 * f * t_out,
        "conv1": c * 6 * f * 3 * t_out + ds,
        "epi": c * 6 * (f + 1) * 2 * t_out + c * 3 * f * t_out,
        "conv2": y1 + ds + conv2 * 14 / 18,
        "full": y1 + ds + conv2,
    }[stage]
    nbytes = (_esize(dtype) * (b * (f + 2) * (t_z + 2) + b * c * f * t_out)
              + 4 * (c * 6 + c + c * c * 6 + c * 3 + c))
    return _bound(flops, nbytes, dtype)


def block0_bound(b: int, length: int, c: int, dtype: str
                 ) -> Tuple[float, str]:
    """(least ms, what bounds it) for one fused_block0 call on the frame of
    a (b, length) waveform: conv1 at the F + 1 y1 rows and the conv2 and
    downsample taps at the 3 * T_out positions the pool keeps, over the peak
    for the type, or the frame read and the output written once over the
    memory rate, whichever is larger."""
    return stage_bound("full", b, length, c, dtype)


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


def bytes_bound(n_in: int, n_out: int, dtype: str) -> Tuple[float, str]:
    """(least ms, "bytes") for a pass that reads ``n_in`` elements once and
    writes ``n_out`` once and does next to no arithmetic on them: the pools
    of ``ops.tail_constructs`` (``n_in`` the 3 V times a row's V outputs
    read) and ``selu_to_nchw``."""
    return _esize(dtype) * (n_in + n_out) / PEAK_BYTES_PER_S * 1e3, "bytes"


def kernel_resources(log: str, kernel: str) -> str:
    """What ptxas said of ``kernel`` in an nvcc log made with ``-Xptxas -v``:
    "N registers, S bytes spill stores, L bytes spill loads"; "reused build"
    when the library was not compiled in this process."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            regs = spill = "?"
            for nxt in lines[i + 1:i + 6]:
                if "spill stores" in nxt:
                    spill = nxt.split("frame,")[-1].strip()
                if "Used" in nxt and "registers" in nxt:
                    regs = nxt.split("Used")[1].split(",")[0].strip()
            return f"{regs}, {spill}"
    return "reused build" if not log else "not in the log"


def rel_err(got, plain) -> float:
    """max |got - plain| / max |plain|, in float32."""
    return ((got.float() - plain.float()).abs().max()
            / plain.float().abs().max()).item()


def mean_err(got, plain) -> float:
    """mean |got - plain| / mean |plain|, in float32, a slice of the batch
    at a time."""
    num = sum((g.float() - p.float()).abs().sum().item()
              for g, p in zip(got.split(16), plain.split(16)))
    den = sum(p.float().abs().sum().item() for p in plain.split(16))
    return num / den


def b0_gate(name: str) -> float:
    """The rel_err gate of the block-0 variant ``name`` (a construct set, a
    stage or a cast-ladder variant; the names do not collide)."""
    if name in B0_SAME_VALUES:
        return B0_GATE_SAME_VALUES
    if name in B0_BF16_EPILOGUES:
        return B0_GATE_BF16_EPILOGUE
    return B0_GATE_STAGE


def b0_fault(name: str, z, block):
    """(z, block) with the fault planted that the gate of variant ``name``
    must tell, or None where no fault is planted: one conv1 tap zeroed for
    the bf16 epilogues, the downsample's bias zeroed for stages ``conv1``
    and ``epi``, one row of the frame zeroed for ``dma`` and ``fill`` (which
    read no weight)."""
    import copy

    import torch

    if name in B0_BF16_EPILOGUES or name in ("conv1", "epi"):
        faulty = copy.deepcopy(block)
        with torch.no_grad():
            if name in B0_BF16_EPILOGUES:
                faulty.conv1.weight[:, 0, 0, 0] = 0
            else:
                faulty.conv_downsample.bias.zero_()
        return z, faulty
    if name in ("dma", "fill"):
        zf = z.clone()
        zf[:, 5] = 0
        return zf, block
    return None


def b0_readings(name: str, got, plain, bad=None, plain_base=None):
    """(text, failures) for the output ``got`` of block-0 variant ``name``
    against its plain version: the readings its gates are on, and the gates
    that failed (none for a sound kernel).  ``bad`` is the kernel's output
    under ``b0_fault``; ``plain_base`` the plain version of the f32
    epilogue, which a bf16 epilogue must be farther from than from its
    own."""
    gate, fails = b0_gate(name), []
    by_mean = name in B0_CHECKED_STAGES
    rel = rel_err(got, plain)
    text = f"error / max|plain| {rel:.3e} (gate {gate})"
    if rel > gate:
        fails.append(f"{name} disagrees with its plain version")
    if by_mean:
        mean = mean_err(got, plain)
        text += (f", mean error / mean|plain| {mean:.3e} (gate "
                 f"{B0_GATE_STAGE_MEAN})")
        if mean > B0_GATE_STAGE_MEAN:
            fails.append(f"{name} disagrees with its plain version in the "
                         "mean")
    if plain_base is not None:
        own, other = mean_err(got, plain), mean_err(got, plain_base)
        text += (f"; mean error / mean|plain| {own:.3e}, against base's "
                 f"plain version {other:.3e} (error / max|plain| "
                 f"{rel_err(got, plain_base):.3e})")
        if not own < other:
            fails.append(f"{name} is no nearer to its own plain version "
                         "than to base's")
    if bad is not None:
        told = mean_err(bad, plain) if by_mean else rel_err(bad, plain)
        text += f"; planted fault: {told:.3e}"
        floor = B0_FAULT_FACTOR * (B0_GATE_STAGE_MEAN if by_mean else gate)
        if told < floor:
            fails.append(f"{name}: a planted fault reads under {floor}")
    return text, fails


def two_runs(fns, iters: int):
    """{name: [ms, ms]}: every ``fns[name]`` timed in order, then in the
    reverse order, so that drift shows as a difference between the runs."""
    order = list(fns)
    runs = {name: [] for name in order}
    for name in order + order[::-1]:
        runs[name].append(cuda_ms(fns[name], iters))
    return runs


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


def block0_case(batch: int, length: int):
    """(z, block, bound ms, what bounds it) for the block-0 probes: the
    pretrained AASIST's block 0 in bfloat16, the padded frontend's frame of
    seeded noise (batch, length), and block 0's bound at that size."""
    import torch

    from aasist_tpu_torch.ops import fused_stack as fs

    model, bank, bn_p, bn_s = pretrained(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((batch, length), generator=gen, device="cuda")
         * 0.1).bfloat16()
    with torch.inference_mode():
        z = fs.fused_frontend_padded(x, bank, bn_p, bn_s)
    bound, by = block0_bound(batch, length, fs.BLOCK0_CHANNELS, "bfloat16")
    return z, model.encoder[0], bound, by


def print_runs(batch: int, runs, width: int, bounds, card: str) -> None:
    """One timing line per entry of ``two_runs``' result, ending in the
    card's line.  ``bounds[name]`` is that entry's (bound ms, what bounds
    it), or None for a build whose output is undefined."""
    for name, ms in runs.items():
        bound = ("no bound: the output is undefined" if bounds[name] is None
                 else "bound {:.4f} ms ({})".format(*bounds[name]))
        print(f"B={batch} bf16 {name:{width}s}: {sum(ms) / 2:8.4f} ms/batch "
              f"(runs {', '.join(f'{v:.4f}' for v in ms)}), {bound}  "
              f"[{card}]", flush=True)
