"""Compile-time variants of the bf16 block-0 kernels, each a function with a
plain PyTorch version.

Counterparts of the kernels of three TPU probes of block 0:

    fused_block0_constructs(z, block, bf16epi, rmw, b2slice)
        tools/probe_b0_constructs.py:run -- block 0 with three constructs
        switched one at a time;
    fused_block0_stage(z, block, stage)
        tools/probe_b0_ablate.py:run -- block 0 cut after each of six
        cumulative stages, every stage writing a defined output;
    fused_block0_epi(z, block, variant)
        tools/probe_b0_epi.py:run -- where conv1's epilogue rounds to bf16.

All are builds of ``csrc/block0_pipe.cu``, the warp-specialised kernel of
the bf16 stack path (``ops.block0_pipe``): their output is that kernel's,
(B, C, F, T_z // 3) stored channels last.  ``fused_block0_constructs_older``,
``fused_block0_stage_older``, ``fused_block0_epi_older`` and
``fused_block0_cut_older`` take the same arguments and launch the same
variants on the older kernel, ``csrc/fused_block0.cu``'s
``block0_tc_kernel`` (NCHW), which the new builds are timed against.
``constructs_build``, ``stage_build``, ``epi_build`` and ``cut_build`` name
the (source, definitions) each variant launches.

All take the zero-bordered frame (B, F + 2, T_z + 2) that
``ops.fused_stack.fused_frontend_padded`` writes and ``fold_block0``'s
tensors, and return (B, C, F, T_z // 3) in the frame's type.  The TPU probes
read ``zt``, mod-3 phase planes cut into overlapping tiles; that layout has
no counterpart here, the functions of z are the same.

Notation.  z[b, f, t] is the frame's interior (zero outside it).
``y1pre`` is conv1 with bn2 folded plus its shift, at rows 0..F (row r reads
z rows r - 1 and r); ``y1m`` is SELU(y1pre), zero at times < 0 and >= T_z and
rounded to the frame's type; ``dsb`` is the downsample plus its bias (row r
reads z row r); t' is a pooled column.

The constructs
    bf16epi  conv1's f32 sum is rounded to bf16, the shift (rounded to bf16)
             is added in bf16 and SELU runs in bf16, op by op; the downsample
             is rounded to bf16 and its bias added in bf16.  On the card this
             is packed ``__nv_bfloat162`` arithmetic, two y1 values at a
             time.
    rmw      conv2's partial sums (one per tap) leave the registers and are
             accumulated by read-modify-write into an f32 tile in shared
             memory.  The default's values, to f32 summation order.
    b2slice  the bias is read from shared memory where it is used, not held
             in a register.  The default's values.

The stages (out is zero in channels 1..C-1 for ``dma`` and ``fill``)
    dma    out[b, 0, r, t'] = z[b, r - 1, 3 (t' - 2)]
    fill   out[b, 0, r, t'] = sum over df in {0, 1}, k in -3..5 of
           z[b, r + df - 1, 3 (t' - 1) + k]: conv1's and the downsample's
           18 operand rows
    conv1  out[b, c, r, t'] = sum over q in 0..2 of y1pre[c, r, 3 (t' - 1) + q]
           + dsb[c, r, 3 (t' - 1) + q], not masked: one pooled column to the
           left of what the full kernel keeps
    epi    out = y1m[c, r, 3 t'] + y1m[c, r + 1, 3 t'] + y1m[c, r, 3 t' - 1]
           + y1m[c, r + 1, 3 t' + 3] + dsb[c, r, 3 t'], the terms rounded to
           the frame's type first and summed in f32
    conv2  block 0 without conv2's two off-split taps: pool phase 0 lacks the
           time tap dt = 0 and phase 2 the tap dt = 2, at both frequency taps
    full   block 0: ``ops.fused_stack.fused_block0``'s function

The cast ladder: ``base``, ``vB`` and ``vD`` round y1 to bf16 once, after an
f32 SELU (they differ in where the 0/1 halo mask is applied: f32 before the
rounding, bf16 after it, f32 before it, so their values are equal); ``vA``
is ``bf16epi``; ``vF`` is ``vA`` with SELU's exponential taken in f32.

One phase removed, for timing only (``fused_block0_cut``; the output has
block 0's shape and no defined values, so there is no plain version and a
CPU tensor raises): ``no_load`` the frame-tile load (on ``block0_pipe.cu``
the producers' issue of the next frame tile), ``no_conv1`` conv1 + SELU,
``no_mma`` conv2's MMA loop, ``no_epi`` the output store (the pool and the
downsample are still computed), ``only_loop`` all four (the persistent
loop, its barriers and the weight loads).  The two sources number these
bits differently (``CUT_BITS``).

The kernels are bfloat16 only: the variants are cut points and epilogues of
the tensor-core kernels.  The f32 kernel runs conv2 on the CUDA cores with
another thread map, has no bf16 epilogue, and a read-modify-write tile does
not fit in shared memory beside its f32 y1 tile.  A float32 CUDA tensor
raises ``TypeError``.  CPU tensors of either type take the plain versions
(``*_reference``), where the bf16 steps of ``bf16epi`` / ``vA`` / ``vF`` are
bf16 whatever the frame's type, as in the TPU probes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from aasist_tpu_torch.ops import block0_pipe as bp
from aasist_tpu_torch.ops import fused_stack as fs

PIPE_SOURCE = "block0_pipe"       # every variant's build
OLDER_SOURCE = "fused_block0"     # the _older wrappers' builds
EPI_VARIANTS = ("base", "vA", "vB", "vD", "vF")
STAGES = ("dma", "fill", "conv1", "epi", "conv2", "full")
CUTS = ("no_load", "no_conv1", "no_mma", "no_epi", "only_loop")
# each source's definition and bits of a cut (its header states them)
CUT_BITS = {
    PIPE_SOURCE: ("B0P_CUT", {"no_load": 4, "no_conv1": 1, "no_mma": 2,
                              "no_epi": 8, "only_loop": 15}),
    OLDER_SOURCE: ("B0_CUT", {"no_load": 1, "no_conv1": 2, "no_mma": 4,
                              "no_epi": 8, "only_loop": 15}),
}
_EPI_CODE = {"base": 0, "vA": 1, "vB": 2, "vD": 3, "vF": 4}
_BF16_EPI = ("vA", "vF")
_SELU_L = 1.0507009873554805
_SELU_A = 1.6732632423543772
_ROWS = 16        # batch rows a plain version handles at a time, for memory


def epi_defines(variant: str) -> Optional[Dict[str, object]]:
    """The preprocessor definitions of a cast-ladder variant."""
    code = _EPI_CODE[variant]
    return {"B0_EPI": code} if code else None


def constructs_defines(bf16epi: bool, rmw: bool, b2slice: bool
                       ) -> Optional[Dict[str, object]]:
    """The preprocessor definitions of a construct set."""
    d: Dict[str, object] = {}
    if bf16epi:
        d["B0_EPI"] = _EPI_CODE["vA"]
    if rmw:
        d["B0_RMW"] = None
    if b2slice:
        d["B0_B2SLICE"] = None
    return d or None


def stage_defines(stage: str) -> Optional[Dict[str, object]]:
    """The preprocessor definitions of a stage."""
    level = STAGES.index(stage)
    if level == len(STAGES) - 1:
        return None
    return {"B0_STAGE": level}


def cut_defines(cut: str, older: bool = False) -> Dict[str, object]:
    """The preprocessor definitions of a build with one phase removed
    (``older``: on ``csrc/fused_block0.cu``)."""
    name, bits = CUT_BITS[OLDER_SOURCE if older else PIPE_SOURCE]
    return {name: bits[cut]}


Build = Tuple[str, Optional[Dict[str, object]]]


def constructs_build(bf16epi: bool, rmw: bool, b2slice: bool,
                     older: bool = False) -> Build:
    """(source, definitions) that ``fused_block0_constructs`` (``older``:
    ``fused_block0_constructs_older``) launches for a construct set."""
    return (OLDER_SOURCE if older else PIPE_SOURCE,
            constructs_defines(bf16epi, rmw, b2slice))


def epi_build(variant: str, older: bool = False) -> Build:
    """(source, definitions) that ``fused_block0_epi`` (``older``:
    ``fused_block0_epi_older``) launches for a cast-ladder variant."""
    return OLDER_SOURCE if older else PIPE_SOURCE, epi_defines(variant)


def stage_build(stage: str, older: bool = False) -> Build:
    """(source, definitions) that ``fused_block0_stage`` (``older``:
    ``fused_block0_stage_older``) launches for a stage."""
    return OLDER_SOURCE if older else PIPE_SOURCE, stage_defines(stage)


def cut_build(cut: str, older: bool = False) -> Build:
    """(source, definitions) that ``fused_block0_cut`` (``older``:
    ``fused_block0_cut_older``) launches for a cut."""
    return OLDER_SOURCE if older else PIPE_SOURCE, cut_defines(cut, older)


# ------------------------------------------------------------ plain versions
def _biases(block: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """(conv2's bias, the downsample's bias), float32."""
    return fs._bias(block.conv2), fs._bias(block.conv_downsample)


def _by_rows(fn: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor
             ) -> torch.Tensor:
    return torch.cat([fn(zs) for zs in z.split(_ROWS)])


def _selu_bf16(y: torch.Tensor, f32_exp: bool) -> torch.Tensor:
    """SELU on a bf16 tensor with every op rounded to bf16 (``f32_exp``: the
    exponential and its ``- 1`` in f32, rounded once)."""
    bf = torch.bfloat16
    zero = torch.zeros((), dtype=bf, device=y.device)
    l = torch.tensor(_SELU_L, dtype=bf, device=y.device)
    la = torch.tensor(_SELU_L * _SELU_A, dtype=bf, device=y.device)
    pos, neg = torch.maximum(y, zero), torch.minimum(y, zero)
    if f32_exp:
        t = (torch.exp(neg.float()) - 1.0).to(bf)
    else:
        t = torch.exp(neg) - 1.0
    return l * pos + la * t


def _y1_padded(z: torch.Tensor, prm: fs.Block0Params, epi: str
               ) -> torch.Tensor:
    """y1m at times -1 .. T_z, the columns conv2 reads: (B, C, F + 1,
    T_z + 2), float32 holding values of the frame's type."""
    c, dtype = prm.w1.shape[0], z.dtype
    s = F.conv2d(F.pad(z.float(), (1, 1))[:, None],
                 prm.w1.reshape(c, 1, 2, 3))            # sums, no shift yet
    mask = torch.ones(s.shape[-1], device=z.device)
    mask[0] = mask[-1] = 0
    sh = prm.shift1[:, None, None]
    if epi in _BF16_EPI:
        y = s.bfloat16() + sh.bfloat16()
        y1 = _selu_bf16(y, epi == "vF") * mask.bfloat16()
        return y1.float()
    y1 = torch.selu(s + sh)
    if epi == "vB":
        return (y1.to(dtype) * mask.to(dtype)).float()
    return (y1 * mask).to(dtype).float()                # base, vD


def _block0_math(z: torch.Tensor, block: torch.nn.Module, epi: str = "base",
                 dense_only: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: folded conv1 in f32, the
    epilogue ``epi``, conv2 on operands of the frame's type summed in f32,
    the downsample, the pool, the biases, one rounding at the end."""
    prm = fs.fold_block0(block)
    b2, bd = _biases(block)
    c, dtype, t_out = prm.w1.shape[0], z.dtype, (z.shape[2] - 2) // 3
    y1 = _y1_padded(z, prm, epi)
    w2 = prm.w2.permute(2, 0, 1).reshape(c, c, 2, 3).to(dtype).float()
    ds = F.conv2d(z.float()[:, None, 1:-1], prm.wd.reshape(c, 1, 1, 3))
    bias = prm.bias
    if epi in _BF16_EPI:
        ds = (ds.bfloat16() + bd.bfloat16()[:, None, None]).float()
        bias = b2
    if dense_only:
        phases = []
        for r in range(3):
            w = w2.clone()
            if r != 1:
                w[..., r] = 0        # phase 0 lacks dt = 0, phase 2 dt = 2
            phases.append(F.conv2d(y1[..., r:], w, stride=(1, 3))[..., :t_out])
        y2 = torch.stack(phases, -1)
        m = (y2 + ds[..., :3 * t_out].reshape(*y2.shape)).amax(-1)
    else:
        m = F.max_pool2d(F.conv2d(y1, w2) + ds, (1, 3))
    return (m + bias[:, None, None]).to(dtype)


def fused_block0_epi_reference(z: torch.Tensor, block: torch.nn.Module,
                               variant: str) -> torch.Tensor:
    """The plain version of ``fused_block0_epi``: the kernel's arithmetic
    with the variant's rounding sequence."""
    _check(block, "fused_block0_epi", variant, EPI_VARIANTS)
    with torch.no_grad():
        return _by_rows(lambda zs: _block0_math(zs, block, variant), z)


def fused_block0_constructs_reference(z: torch.Tensor,
                                      block: torch.nn.Module,
                                      bf16epi: bool = False,
                                      rmw: bool = False,
                                      b2slice: bool = False) -> torch.Tensor:
    """The plain version of ``fused_block0_constructs``.  ``rmw`` and
    ``b2slice`` change how the kernel holds its sums and its bias, not the
    function."""
    return fused_block0_epi_reference(z, block, "vA" if bf16epi else "base")


def _stage_math(z: torch.Tensor, block: torch.nn.Module, stage: str
                ) -> torch.Tensor:
    prm = fs.fold_block0(block)
    _, bd = _biases(block)
    c, dtype = prm.w1.shape[0], z.dtype
    b, f, t_z = z.shape[0], z.shape[1] - 2, z.shape[2] - 2
    t_out = t_z // 3
    zf = z.float()
    if stage in ("dma", "fill"):
        zp = F.pad(zf, (5, 0))           # column p holds frame column p - 5
        out = zf.new_zeros((b, c, f, t_out))
        if stage == "dma":
            out[:, 0] = zp[:, :f, 0:3 * t_out:3]
        else:
            out[:, 0] = F.conv2d(zp[:, None], zf.new_ones((1, 1, 2, 9)),
                                 stride=(1, 3))[:, 0, :f, :t_out]
    elif stage == "conv1":
        zp = F.pad(zf, (3, 0))           # output column j is time j - 3
        y = F.conv2d(zp[:, None], prm.w1.reshape(c, 1, 2, 3)) + \
            prm.shift1[:, None, None]
        d = F.conv2d(zp[:, None, 1:-1], prm.wd.reshape(c, 1, 1, 3)) + \
            bd[:, None, None]
        tot = y[:, :, :f, :3 * t_out] + d[..., :3 * t_out]
        out = tot.reshape(b, c, f, t_out, 3).sum(-1)
    else:                                # epi
        y1 = _y1_padded(z, prm, "base")  # column j is time j - 1
        dsb = (F.conv2d(zf[:, None, 1:-1], prm.wd.reshape(c, 1, 1, 3))
               + bd[:, None, None]).to(dtype).float()
        n = 3 * t_out
        out = (y1[:, :, :f, 1:1 + n:3] + y1[:, :, 1:f + 1, 1:1 + n:3]
               + y1[:, :, :f, 0:n:3] + y1[:, :, 1:f + 1, 4:4 + n:3]
               + dsb[..., 0:n:3])
    return out.to(dtype)


def fused_block0_stage_reference(z: torch.Tensor, block: torch.nn.Module,
                                 stage: str) -> torch.Tensor:
    """The plain version of ``fused_block0_stage`` (the module's header has
    each stage's function)."""
    _check(block, "fused_block0_stage", stage, STAGES)
    if stage == "full":
        return fs.fused_block0_reference(z, block)
    with torch.no_grad():
        if stage == "conv2":
            return _by_rows(
                lambda zs: _block0_math(zs, block, dense_only=True), z)
        return _by_rows(lambda zs: _stage_math(zs, block, stage), z)


# ------------------------------------------------------------------ wrappers
def _check(block: torch.nn.Module, name: str, choice: str, choices) -> None:
    fs._check_block0(block, name)
    if choice not in choices:
        raise ValueError(f"{name}: {choice!r} is not one of {choices}")


def variant_bias(block: torch.nn.Module) -> torch.Tensor:
    """The (3, C) bias passed to every variant build: conv2's plus the
    downsample's, the downsample's, conv2's (the builds without a bf16
    epilogue read the first row only)."""
    b2, bd = _biases(block)
    return torch.stack([b2 + bd, bd, b2]).contiguous()


def _launch(name: str, z: torch.Tensor, block: torch.nn.Module,
            build: Build) -> torch.Tensor:
    """Launch a variant build on a CUDA frame."""
    source, defines = build
    if source == PIPE_SOURCE:
        return bp._launch(name, z, block, defines, bias=variant_bias(block))
    return fs.launch_block0(name, z, block, defines=defines,
                            bias=variant_bias(block),
                            dtypes=(torch.bfloat16,))


def fused_block0_constructs(z: torch.Tensor, block: torch.nn.Module,
                            bf16epi: bool = False, rmw: bool = False,
                            b2slice: bool = False) -> torch.Tensor:
    """Block 0 (eval) on the zero-bordered frame, (B, F + 2, T_z + 2) ->
    (B, C, F, T_z // 3), with the chosen constructs switched on (the
    module's header describes them), on ``csrc/block0_pipe.cu``: channels
    last.  bfloat16 on CUDA.  Every launch adds one to
    ``fused_block0_constructs.launches``."""
    fs._check_block0(block, "fused_block0_constructs")
    if z.device.type == "cpu":
        return fused_block0_constructs_reference(z, block, bf16epi, rmw,
                                                 b2slice)
    out = _launch("fused_block0_constructs", z, block,
                  constructs_build(bf16epi, rmw, b2slice))
    fused_block0_constructs.launches += 1
    return out


def fused_block0_constructs_older(z: torch.Tensor, block: torch.nn.Module,
                                  bf16epi: bool = False, rmw: bool = False,
                                  b2slice: bool = False) -> torch.Tensor:
    """``fused_block0_constructs`` on the older kernel
    (``csrc/fused_block0.cu``, NCHW).  Every launch adds one to
    ``fused_block0_constructs_older.launches``."""
    fs._check_block0(block, "fused_block0_constructs_older")
    if z.device.type == "cpu":
        return fused_block0_constructs_reference(z, block, bf16epi, rmw,
                                                 b2slice)
    out = _launch("fused_block0_constructs_older", z, block,
                  constructs_build(bf16epi, rmw, b2slice, older=True))
    fused_block0_constructs_older.launches += 1
    return out


def fused_block0_stage(z: torch.Tensor, block: torch.nn.Module, stage: str
                       ) -> torch.Tensor:
    """Block 0 cut after ``stage`` (one of ``STAGES``), the work done so far
    reduced into a (B, C, F, T_z // 3) output (the module's header has each
    stage's function), on ``csrc/block0_pipe.cu``: channels last.  bfloat16
    on CUDA.  Every launch adds one to ``fused_block0_stage.launches``."""
    _check(block, "fused_block0_stage", stage, STAGES)
    if z.device.type == "cpu":
        return fused_block0_stage_reference(z, block, stage)
    out = _launch("fused_block0_stage", z, block, stage_build(stage))
    fused_block0_stage.launches += 1
    return out


def fused_block0_stage_older(z: torch.Tensor, block: torch.nn.Module,
                             stage: str) -> torch.Tensor:
    """``fused_block0_stage`` on the older kernel (``csrc/fused_block0.cu``,
    NCHW).  Every launch adds one to ``fused_block0_stage_older.launches``."""
    _check(block, "fused_block0_stage_older", stage, STAGES)
    if z.device.type == "cpu":
        return fused_block0_stage_reference(z, block, stage)
    out = _launch("fused_block0_stage_older", z, block,
                  stage_build(stage, older=True))
    fused_block0_stage_older.launches += 1
    return out


def fused_block0_epi(z: torch.Tensor, block: torch.nn.Module, variant: str
                     ) -> torch.Tensor:
    """Block 0 with conv1's epilogue rounding to bf16 where ``variant`` (one
    of ``EPI_VARIANTS``) says, on ``csrc/block0_pipe.cu``: channels last.
    bfloat16 on CUDA.  Every launch adds one to
    ``fused_block0_epi.launches``."""
    _check(block, "fused_block0_epi", variant, EPI_VARIANTS)
    if z.device.type == "cpu":
        return fused_block0_epi_reference(z, block, variant)
    out = _launch("fused_block0_epi", z, block, epi_build(variant))
    fused_block0_epi.launches += 1
    return out


def fused_block0_epi_older(z: torch.Tensor, block: torch.nn.Module,
                           variant: str) -> torch.Tensor:
    """``fused_block0_epi`` on the older kernel (``csrc/fused_block0.cu``,
    NCHW).  Every launch adds one to ``fused_block0_epi_older.launches``."""
    _check(block, "fused_block0_epi_older", variant, EPI_VARIANTS)
    if z.device.type == "cpu":
        return fused_block0_epi_reference(z, block, variant)
    out = _launch("fused_block0_epi_older", z, block,
                  epi_build(variant, older=True))
    fused_block0_epi_older.launches += 1
    return out


def fused_block0_cut(z: torch.Tensor, block: torch.nn.Module, cut: str
                     ) -> torch.Tensor:
    """Launch block 0 with the phase ``cut`` (one of ``CUTS``) removed, to
    time it, on ``csrc/block0_pipe.cu``: the (B, C, F, T_z // 3) result
    holds no defined values.  bfloat16 on CUDA only.  Every launch adds one
    to ``fused_block0_cut.launches``."""
    _check(block, "fused_block0_cut", cut, CUTS)
    out = _launch("fused_block0_cut", z, block, cut_build(cut))
    fused_block0_cut.launches += 1
    return out


def fused_block0_cut_older(z: torch.Tensor, block: torch.nn.Module, cut: str
                           ) -> torch.Tensor:
    """``fused_block0_cut`` on the older kernel (``csrc/fused_block0.cu``).
    Every launch adds one to ``fused_block0_cut_older.launches``."""
    _check(block, "fused_block0_cut_older", cut, CUTS)
    out = _launch("fused_block0_cut_older", z, block,
                  cut_build(cut, older=True))
    fused_block0_cut_older.launches += 1
    return out


fused_block0_constructs.launches = 0
fused_block0_constructs_older.launches = 0
fused_block0_cut.launches = 0
fused_block0_cut_older.launches = 0
fused_block0_stage.launches = 0
fused_block0_stage_older.launches = 0
fused_block0_epi.launches = 0
fused_block0_epi_older.launches = 0
