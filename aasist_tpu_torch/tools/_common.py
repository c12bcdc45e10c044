"""What the on-card tools share: the card's line, CUDA-event timing, the
kernels' bounds, and the pretrained AASIST's frontend and block 0."""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]

# H100 SXM data-sheet peaks (dense), for the kernels' bounds.  "tf32x3":
# float32 products on the tensor cores by the 3xTF32 split, three TF32
# products (494.5 TFLOP/s dense) for each, which keeps f32 accuracy
# (csrc/frontend_f32.cu, csrc/block0_f32.cu); a float32 function's least
# time is the smaller of its CUDA-core and its 3xTF32 bound.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 494.5e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
F32_PEAKS = ("float32", "tf32x3")
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


# Rows of the 512-utterance e2e goldens (seed-99 corpus) whose score turns
# on a near-tie of node order inside the model, each with its f32 reading
# in the other order; the parity gates hold such a row by id to the golden
# or to that reading, every other row to the golden.
#   AASIST's LA_E_9900077: the sigmoid scores of pool_hS1's 3rd and 4th
# kept nodes are equal in f32 (0.5312195) and 1.06e-7 apart in float64; the
# two branches are joined by an element-wise max over nodes in rank order,
# so the order of that pair moves the score by 7.1e-3.  The torch reference
# that made the golden took one order (-6.7885728), the JAX package and the
# port the other (tests/test_torch_eval_pipeline.py::
# test_the_512_goldens_utterance_77_is_a_node_order_tie recomputes both).
NODE_ORDER_TIES = {"LA99": {"LA_E_9900077": -6.7956948}}
#   RawGAT-ST's LA_E_9900049: pool_ST's 4th and 5th kept nodes score 6.1e-9
# apart in float64 (below an f32 ulp there), and proj_ST / out_layer weigh
# the 7 kept nodes by rank, so their order moves the score by 1.83e-3.  The
# torch reference, the JAX package and the port on the CPU take one order
# (golden 0.1959048); the port's f32 forward with that pair swapped gives
# 0.1940752, which an H100 reads in f32 bit for bit
# (tests/test_torch_zoo_eval.py::
# test_the_rawgatst_goldens_utterance_49_is_a_node_order_tie).
ZOO_NODE_ORDER_TIES = {"RawGATST": {"LA_E_9900049": 0.19407523}}


def need_card(tool: str) -> None:
    """Exit non-zero unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: needs a CUDA card")


def tool_device(tool: str, device: str):
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises, as the CLI does."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: no CUDA device is available; pass "
                           "--device cpu to run on the CPU")
    return device


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


def graph_ms(fn, reps: int, iters: int) -> float:
    """Device time of one ``fn()`` for a call shorter than the host's time to
    launch it: ``reps`` calls captured in a CUDA graph, the graph replayed
    (``cuda_ms``), over ``reps``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters) / reps


def _bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _bounds(flops: float, nbytes: float, dtype: str, all_bounds: bool):
    """(least ms, what bounds it) for ``dtype``: for float32 the smaller of
    the CUDA-core and the 3xTF32 bound.  ``all_bounds``: every candidate
    instead, {peak: (ms, what bounds it)} (``least_bound`` picks)."""
    peaks = F32_PEAKS if dtype == "float32" else (dtype,)
    every = {p: _bound(flops, nbytes, p) for p in peaks}
    return every if all_bounds else least_bound(every)[:2]


def least_bound(every) -> Tuple[float, str, str]:
    """(ms, what bounds it, the peak) of the least of ``every``, a
    {peak: (ms, what bounds it)} from a bound's ``all_bounds``."""
    peak = min(every, key=lambda p: every[p][0])
    return every[peak][0], every[peak][1], peak


def f64_err(out, fn, x, *rest, rows: int = 16) -> float:
    """max |out - fn(x, *rest) in float64| over the first ``rows`` batch
    rows: a kernel against its plain version in float64 (tensors, dicts of
    tensors and modules copied to float64), not gated."""
    import copy

    import torch

    def f64(a):
        if isinstance(a, torch.Tensor):
            return a.double()
        if isinstance(a, dict):
            return {k: f64(v) for k, v in a.items()}
        if isinstance(a, torch.nn.Module):
            return copy.deepcopy(a).double()
        return a

    with torch.inference_mode():
        ref = fn(x[:rows].double(), *(f64(a) for a in rest))
        return (out[:rows].double() - ref).abs().max().item()


def _esize(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def frontend_bound(b: int, length: int, c: int, dtype: str,
                   padded: bool = False, rows: Optional[int] = None,
                   all_bounds: bool = False):
    """(least ms, what bounds it) for one fused-frontend call: the conv's
    FLOPs over the peak for the type, or the bytes read and written once
    over the memory rate, whichever is larger; float32 takes the smaller of
    its CUDA-core and 3xTF32 bounds (``all_bounds``: both, by peak).
    ``padded``: the output is the zero-bordered frame; ``rows``: it is
    stored in that many rows."""
    f_out, t_out = c // 3, (length - 128) // 3
    flops = 2.0 * b * (3 * f_out) * (3 * t_out) * 129
    n_out = ((f_out + 2) * (t_out + 2) if padded
             else (rows or f_out) * t_out)
    nbytes = _esize(dtype) * (b * length + c * 129 + b * n_out) + 16
    return _bounds(flops, nbytes, dtype, all_bounds)


def stage_bound(stage: str, b: int, length: int, c: int, dtype: str,
                all_bounds: bool = False):
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
    over the memory rate; float32 takes the smaller of its CUDA-core and
    3xTF32 bounds (``all_bounds``: both, by peak)."""
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
    return _bounds(flops, nbytes, dtype, all_bounds)


def block0_bound(b: int, length: int, c: int, dtype: str,
                 all_bounds: bool = False):
    """(least ms, what bounds it) for one fused_block0 call on the frame of
    a (b, length) waveform: conv1 at the F + 1 y1 rows and the conv2 and
    downsample taps at the 3 * T_out positions the pool keeps, over the peak
    for the type, or the frame read and the output written once over the
    memory rate, whichever is larger; float32 takes the smaller of its
    CUDA-core and 3xTF32 bounds (``all_bounds``: both, by peak)."""
    return stage_bound("full", b, length, c, dtype, all_bounds)


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


# Rows of x read and of the output written, per (channel, batch row, time),
# by each step-cost mode (``ops.stepcost``).  matmul's output rows 0 .. 22
# take d's low half at rows 0 .. 22 and its high half at rows 1 .. 23, so
# its dots read x rows 0 .. 25; matblk's one more row reads 0 .. 26.
STEPCOST_ROWS = {"nop": (0, 23), "nopF32": (0, 32), "nopblk": (0, 32),
                 "copy": (23, 23), "matmul": (26, 23), "matblk": (27, 32)}
STEPCOST_DOT_ROWS = {"matmul": 23, "matblk": 24}


def stepcost_flops(mode: str, b: int, t: int) -> float:
    """The FLOPs ``mode``'s function needs on x (32, b, 32, t): for each
    output row and position, both halves' 96-term dots (2 x 96 x 32 each);
    none for the other modes.  (The JAX probe counts all 64 outputs at 25
    rows of d, 9 % more than matmul needs.)"""
    return 2.0 * 96 * 64 * b * t * STEPCOST_DOT_ROWS.get(mode, 0)


def stepcost_bound(mode: str, b: int, t: int) -> Tuple[float, str]:
    """(least ms, what bounds it) for one ``stepcost`` call on x (32, b, 32,
    t), bf16: the mode's rows read and written once over the memory rate
    (``STEPCOST_ROWS``; w too for the dots), or ``stepcost_flops`` over the
    bf16 peak, whichever is larger.  At b = 128, t = 7168: nop 0.403 ms,
    nopF32 and nopblk 0.561, copy 0.806, matmul 0.859 (its FLOPs 0.262),
    matblk 1.034 (0.274), all bytes."""
    rows_in, rows_out = STEPCOST_ROWS[mode]
    nbytes = 2.0 * 32 * b * t * (rows_in + rows_out)
    if mode in STEPCOST_DOT_ROWS:
        nbytes += 2 * 96 * 64
    return _bound(stepcost_flops(mode, b, t), nbytes, "bfloat16")


def mma_chain_bound(k: int, m: int, n_cols: int) -> Tuple[float, str]:
    """(least ms, "operations") for one dot of ``mma_chain``: 2 K M N useful
    FLOP over the bf16 peak.  The operands stay on chip between dots, so a
    dot moves no device memory."""
    return 2.0 * k * m * n_cols / PEAK_FLOPS["bfloat16"] * 1e3, "operations"


# Gates of the step-cost kernels against ``ops.stepcost.stepcost_reference``
# as (atol, rtol) of |kernel - plain| <= atol + rtol |plain|, element by
# element, with ``out`` filled with NaN before the launch so that an element
# the kernel does not write fails.  The nop modes and copy store 1.0 or
# stored values: exact.  matmul and matblk sum the same 96 exact bf16
# products in f32 in another order, add the halves and round once: one bf16
# ulp (rtol 2^-7) apart; near zero the f32 order error shows, ~2^-24 of the
# ~150 that |terms| sum to at N(0, 1) inputs, so atol 1e-4 is ten times it.
# A planted fault (copy: one row of x zeroed; matmul, matblk: one K row of w
# zeroed; the nop modes: one element of the output left as NaN) must put
# elements over the gate.  Readings at B = 128, T = 7168: no element over,
# the dots at most 0.25 apart (one ulp of |out| ~ 16-32); the faults put 1
# (nop modes), 2.9e7 (copy) and 6.2e8 of 6.8e8 (matmul) elements over.
# (NVIDIA H100 80GB HBM3, 700.00 W; the probe prints them.)
STEPCOST_EXACT = ("nop", "nopF32", "nopblk", "copy")
STEPCOST_DOTS_TOL = (1e-4, 2.0 ** -7)


def stepcost_gate(mode: str) -> Tuple[float, float]:
    """(atol, rtol) of step-cost mode ``mode``."""
    return (0.0, 0.0) if mode in STEPCOST_EXACT else STEPCOST_DOTS_TOL


def _over(got, plain, atol: float, rtol: float) -> Tuple[int, float]:
    """(elements with |got - plain| > atol + rtol |plain| or not finite,
    max |got - plain|), in float32, 2^26 elements at a time."""
    n, worst = 0, 0.0
    for g, p in zip(got.reshape(-1).split(1 << 26),
                    plain.reshape(-1).split(1 << 26)):
        d = (g.float() - p.float()).abs()
        n += int((~(d <= atol + rtol * p.float().abs())).sum().item())
        worst = max(worst, d.nan_to_num(float("inf")).max().item())
    return n, worst


def max_abs_err(got, plain) -> float:
    """max |got - plain| in float32 over tensors of one number of elements
    (inf where either is not finite)."""
    return _over(got, plain, 0.0, 0.0)[1]


def stepcost_readings(mode: str, got, plain, bad=None):
    """(text, failures) for step-cost output ``got`` of ``mode`` against its
    plain version (``stepcost_gate``); ``bad`` is the output under the
    planted fault, which must fail the gate."""
    atol, rtol = stepcost_gate(mode)
    n, worst = _over(got, plain, atol, rtol)
    text = (f"elements over (atol {atol}, rtol {rtol:.3e}): {n} of "
            f"{plain.numel()}, max|kernel - plain| {worst:.3e}")
    fails = [f"{mode}: {n} elements disagree with its plain version"] if n \
        else []
    if bad is not None:
        n_bad, worst_bad = _over(bad, plain, atol, rtol)
        text += f"; planted fault: {n_bad} over, max {worst_bad:.3e}"
        if not n_bad:
            fails.append(f"{mode}: the gate does not tell the planted fault")
    return text, fails


def stepcost_bad(mode: str, x, w, run):
    """The output of ``run(x, w)`` (a step-cost call) under ``mode``'s
    planted fault (``stepcost_gate``)."""
    if mode in STEPCOST_EXACT and mode != "copy":
        bad = run(x, w).clone()
        bad.view(-1)[bad.numel() // 2] = float("nan")
        return bad
    x, w = x.clone(), w.clone()
    if mode == "copy":
        x[:, :, 5] = 0
    else:
        w[w.shape[0] // 2] = 0
    return run(x, w)


# Gates of ``mma_chain`` against ``mma_chain_reference`` at a visible eps,
# MMA_EPS_SCALE / (K M) on N(0, 1) w and a (an update of ~4 a dot, against
# |a| ~ 1), over MMA_CHECK_ITERS dots.  Rows 1.. are copied: exact.  Row 0:
# the kernel sums y^2 in another order, so bf16(eps s) or the add may round
# the other way, an ulp of a[0] (2^-8 to 2^-7 of max|row 0|) that the next
# dots carry on: gate 2^-6 of max|row 0| on the largest error.  An ulp hides
# small faults, so row 0 is also gated on mean|kernel - plain| / mean|plain|
# at MMA_GATE_MEAN, where rare flips vanish and a fault in every column does
# not: one K row of w zeroed moves s by ~2 / sqrt(K M) in each column, which
# must read MMA_FAULT_FACTOR times the mean gate.  Readings on the twelve
# shapes: sound 0 (eleven) and 2.8e-3 / 2.3e-6 (k256_m256, one flip), the
# fault 7.0e-3 (k384_m96) to 0.20 (k12_m192) in the mean; the mean gate,
# 1e-4, is forty times the one flip and a seventieth of the least fault.
# (NVIDIA H100 80GB HBM3, 700.00 W; the probe prints them.)
MMA_EPS_SCALE = 4.0
MMA_CHECK_ITERS = 3
MMA_GATE_MAX = 2.0 ** -6
MMA_GATE_MEAN = 1e-4
MMA_FAULT_FACTOR = 5


def mma_eps(k: int, m: int) -> float:
    """The visible eps of the (K, M) check."""
    return MMA_EPS_SCALE / (k * m)


def mma_gate() -> Tuple[float, float]:
    """(gate on the largest, gate on the mean) row-0 error of
    ``mma_chain``."""
    return MMA_GATE_MAX, MMA_GATE_MEAN


def mma_bad(w, a, run):
    """The output of ``run(w, a)`` (an ``mma_chain`` call) with the planted
    fault: w's middle K row zeroed."""
    w = w.clone()
    w[w.shape[0] // 2] = 0
    return run(w, a)


def mma_readings(name: str, got, plain, a, bad=None):
    """(text, failures) for ``mma_chain``'s output ``got`` from input ``a``
    against its plain version at the visible eps (``mma_eps``, gates
    ``mma_gate``); ``bad`` is the output under ``mma_bad``."""
    gate_max, gate_mean = mma_gate()
    fails = []
    rows_exact = bool((got[1:] == a[1:]).all())
    if not rows_exact:
        fails.append(f"{name}: rows 1.. differ from the input")
    changed = (plain[0] != a[0]).float().mean().item()
    if changed < 0.5:
        fails.append(f"{name}: the update moved {changed:.1%} of row 0: eps "
                     "is not visible")
    rel, mean = rel_err(got[0], plain[0]), mean_err(got[:1], plain[:1])
    text = (f"row 0 error / max|plain| {rel:.3e} (gate {gate_max:.3e}), "
            f"mean error / mean|plain| {mean:.3e} (gate {gate_mean}); "
            f"rows 1.. {'exact' if rows_exact else 'DIFFER'}; "
            f"{changed:.1%} of row 0 moved by the update")
    if not rel <= gate_max:
        fails.append(f"{name}: row 0 disagrees with its plain version")
    if not mean <= gate_mean:
        fails.append(f"{name}: row 0 disagrees with its plain version in "
                     "the mean")
    if bad is not None:
        told = mean_err(bad[:1], plain[:1])
        text += f"; planted fault: {told:.3e}"
        if not told >= MMA_FAULT_FACTOR * gate_mean:
            fails.append(f"{name}: a planted fault reads under "
                         f"{MMA_FAULT_FACTOR * gate_mean}")
    return text, fails


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
