"""Residual block 0 on the card with its phases overlapped
(``csrc/block0_pipe.cu``), and the phase timer of both block-0 kernels.

Counterpart of ``tools/fused_stack.py:_b0_run``, as ``ops.fused_stack.
fused_block0_mma`` is; this kernel computes that kernel's function to the
bit, with producer warps building the next item's conv1 + SELU tile while
consumer warps run conv2 on the current one, frame tiles loaded ahead with
``cp.async``, and work items of all F rows and 16 pooled columns (the
source's header says why).  Its output is stored channels last
(``torch.channels_last``: (B, F, T, C) in memory), which lets it write whole
sectors and which cuDNN's convolutions of blocks 1-5 keep; the values are
those of the other kernels.  bfloat16 only: a float32 frame raises
``TypeError`` (``ops.fused_stack.fused_block0`` sends float32 to the CUDA-core
kernel); CPU tensors take the plain version, ``block0_pipe_reference``.

    block0_pipe(z, block)                 -> (B, C, F, T_z // 3)
    block0_timed(z, block, kernel)        -> (output, ms per phase)
    block0_pipe_cut(z, block, cut)        -> timing only, no defined values

``pipe_work`` / ``pipe_items`` state the kernel's work decomposition, which
the wrapper passes to it.  ``phase_ms`` turns the timer builds' side buffer
(``B0P_TIMER``, one row of 64-bit words per CTA) into ms per phase; it is
plain Python, so that a test can run it on a made-up buffer.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch

from aasist_tpu_torch.ops import fused_stack as fs

PIPE_TO = 16          # pooled columns of a work item
PIPE_RB = 23          # output rows of a band

# The timer's slots (both sources): 0 / 1 the CTA's first and last clock64,
# 2 / 3 its first and last %globaltimer in ns, 4 its items; then clock64
# deltas summed over the items, per phase of each kernel.
TIMER_SLOTS = 12
TIMER_PHASES = {
    "pipe": {5: "producers: wait for an empty buffer",
             6: "producers: issue the next frame tile",
             7: "producers: wait for this frame tile",
             8: "producers: conv1 + SELU",
             9: "consumers: wait for a full buffer",
             10: "consumers: conv2 MMA loop",
             11: "consumers: downsample, pool, store"},
    "mma": {5: "frame-tile load (two barriers)",
            6: "conv1 + SELU (one barrier)",
            7: "conv2 MMA loop",
            8: "downsample, pool, store"},
}
PIPE_CUTS = {"no_conv1": 1, "no_mma": 2, "skeleton": 3}


def pipe_work(b: int, f: int, t_out: int) -> Tuple[int, int, int]:
    """(n_tiles, n_bands, n_work) of the kernel for a (B, C, F, T_out)
    output."""
    n_tiles = -(-t_out // PIPE_TO)
    n_bands = -(-f // PIPE_RB)
    return n_tiles, n_bands, b * n_bands * n_tiles


def pipe_items(b: int, f: int, t_out: int
               ) -> Iterator[Tuple[int, int, int, int, int]]:
    """Every work item of ``pipe_work`` as (batch row, first row, end row,
    first pooled column, end column): the outputs each item stores."""
    n_tiles, n_bands, n_work = pipe_work(b, f, t_out)
    for w in range(n_work):
        rest = w // n_tiles
        f0 = (rest % n_bands) * PIPE_RB
        t0 = (w % n_tiles) * PIPE_TO
        yield (rest // n_bands, f0, min(f0 + PIPE_RB, f), t0,
               min(t0 + PIPE_TO, t_out))


def phase_ms(buf, kernel: str) -> Dict[str, float]:
    """The timer's side buffer, a (CTAs, 12) array of clock words, -> ms per
    phase of ``kernel`` ("pipe" or "mma"), averaged over the CTAs that ran
    an item, with "cta" the CTAs' mean life and "clock_ghz" the clock64
    rate that %globaltimer gives.  Each phase's clocks are turned into ms at
    its own CTA's rate."""
    rows = [[int(v) for v in row] for row in buf]
    rows = [r for r in rows if r[4] > 0 and r[3] > r[2] and r[1] > r[0]]
    if not rows:
        raise ValueError("phase_ms: no CTA ran an item")
    out: Dict[str, float] = {}
    for slot, name in TIMER_PHASES[kernel].items():
        out[name] = sum(r[slot] * (r[3] - r[2]) / (r[1] - r[0])
                        for r in rows) / len(rows) / 1e6
    out["cta"] = sum(r[3] - r[2] for r in rows) / len(rows) / 1e6
    out["clock_ghz"] = sum((r[1] - r[0]) / (r[3] - r[2])
                           for r in rows) / len(rows)
    return out


def block0_pipe_reference(z: torch.Tensor, block: torch.nn.Module
                          ) -> torch.Tensor:
    """The plain version: ``ops.fused_stack.fused_block0_reference``."""
    return fs.fused_block0_reference(z, block)


def _launch(name: str, z: torch.Tensor, block: torch.nn.Module,
            defines: Optional[Mapping[str, object]] = None,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Check a CUDA call of ``csrc/block0_pipe.cu``'s build ``defines`` and
    launch it; ``bias`` replaces ``fold_block0``'s (the probes' builds read
    (3, C): ``ops.block0_variants`` passes it)."""
    b, f_out, t_z, c, p = fs.check_frame(name, z, block, (torch.bfloat16,))
    if bias is not None:
        p = p._replace(bias=bias)
    t_out = t_z // 3
    n_tiles, n_bands, n_work = pipe_work(b, f_out, t_out)
    if n_work >= 2 ** 31:
        raise ValueError(f"{name}: {n_work} work items exceed the kernel's "
                         "int range")

    from aasist_tpu_torch.ops import _build
    fn = _build.load("block0_pipe", defines).lib.aasist_block0_pipe
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, c, f_out, t_out), dtype=z.dtype, device=z.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(z.data_ptr(), *(t.data_ptr() for t in p), out.data_ptr(),
                 b, f_out, t_z, c, n_tiles, n_bands, n_work, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
    return out


def block0_pipe(z: torch.Tensor, block: torch.nn.Module) -> torch.Tensor:
    """Residual block 0 (eval) on the zero-bordered bf16 frame
    (B, F + 2, T_z + 2) -> (B, C, F, T_z // 3), channels last on a card:
    ``ops.fused_stack.fused_block0``'s function, its bf16 route.  Every
    launch adds one to ``block0_pipe.launches``."""
    fs._check_block0(block, "block0_pipe")
    if z.device.type == "cpu":
        return block0_pipe_reference(z, block)
    out = _launch("block0_pipe", z, block)
    block0_pipe.launches += 1
    return out


def block0_pipe_cut(z: torch.Tensor, block: torch.nn.Module, cut: str
                    ) -> torch.Tensor:
    """A timing build of ``block0_pipe`` with the phases of ``PIPE_CUTS``
    removed: block 0's output shape, no defined values (CUDA only; there is
    no plain version).  Every launch adds one to
    ``block0_pipe_cut.launches``."""
    if cut not in PIPE_CUTS:
        raise ValueError(f"block0_pipe_cut: unknown cut {cut!r}")
    out = _launch("block0_pipe_cut", z, block, {"B0P_CUT": PIPE_CUTS[cut]})
    block0_pipe_cut.launches += 1
    return out


TIMER_DEFINES = {"B0P_TIMER": None}


def block0_timed(z: torch.Tensor, block: torch.nn.Module, kernel: str,
                 defines: Optional[Mapping[str, object]] = None,
                 bias: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """One launch of the timer build of ``kernel`` ("pipe":
    ``csrc/block0_pipe.cu``, with the further ``defines`` and ``bias`` of a
    probe build if given; "mma": ``csrc/fused_block0.cu``'s bf16 kernel) on
    a bf16 CUDA frame: (its output, ``phase_ms`` of its side buffer).  The
    output is that of the build without the timer.  Every launch adds one
    to ``block0_timed.launches``."""
    from aasist_tpu_torch.ops import _build
    if kernel == "pipe":
        both = {**TIMER_DEFINES, **(defines or {})}
        out = _launch("block0_timed", z, block, both, bias)
        read = _build.load("block0_pipe", both).lib.aasist_block0_pipe_timer
    elif defines or bias is not None:
        raise ValueError("block0_timed: only the pipe kernel's timer takes "
                         "a probe build")
    elif kernel == "mma":
        out = fs.launch_block0("block0_timed", z, block, TIMER_DEFINES,
                               dtypes=(torch.bfloat16,))
        read = _build.load("fused_block0", TIMER_DEFINES).lib \
            .aasist_fused_block0_timer
    else:
        raise ValueError(f"block0_timed: unknown kernel {kernel!r}")
    block0_timed.launches += 1
    read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                     ctypes.c_void_p]
    read.restype = ctypes.c_int
    buf = torch.zeros((1024, TIMER_SLOTS), dtype=torch.int64,
                      device=z.device)
    ctas = ctypes.c_int(0)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = read(buf.data_ptr(), ctypes.byref(ctas), stream)
    if err != 0:
        raise RuntimeError(f"block0_timed: reading the timer failed "
                           f"(cudaError_t {err})")
    return out, phase_ms(buf[:ctas.value].cpu().tolist(), kernel)


block0_pipe.launches = 0
block0_pipe_cut.launches = 0
block0_timed.launches = 0
