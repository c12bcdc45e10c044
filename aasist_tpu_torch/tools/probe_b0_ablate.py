"""Where the bf16 block-0 kernel's time goes: the kernel cut after each of
six cumulative stages, each stage checked against a plain version, and the
kernel with one phase removed at a time.

    python3 -m aasist_tpu_torch.tools.probe_b0_ablate       # one CUDA card

Counterpart of ``tools/probe_b0_ablate.py``.  B = 128, L = 64,600, bfloat16,
the pretrained AASIST's block 0 on the padded frontend's output.  Builds of
``csrc/fused_block0.cu`` with preprocessor definitions, all built together.

Stages (``ops.block0_variants.fused_block0_stage``; its module states each
stage's function).  A stage ends the work item after its phase and reduces
what it computed into the output tile, so no work is dead code, and its
output is held against the stage's plain version on the first 16 rows (max
error over max |plain|; sums of up to 18 terms; stages ``dma`` .. ``epi``
also in the mean, with the reading of a planted fault beside it).  A stage
that fails a gate (``tools/_common.py:b0_readings``, the gates of
``chip_smoke.py``) ends the run with an error.  Each stage's time stands
beside the bound of what that stage must do (``_common.stage_bound``):

  dma < fill < conv1 < epi < conv2 < full

One phase removed (``ops.block0_variants.fused_block0_cut``; the output is
undefined, only the time is read, and there is no bound): the frame-tile
load, conv1 + SELU, conv2's MMA loop, the output store (``no_epi``; the pool
and downsample are still computed), and all four (the persistent loop, its
barriers and the weight loads).  The phases of an item run one after
another between barriers, so the cuts do not add up exactly.
"""

from __future__ import annotations

import argparse
import sys

from aasist_tpu_torch.tools import _common

LENGTH = 64600
BATCH = 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    _common.need_card("probe_b0_ablate")

    import torch

    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import block0_variants as bv

    torch.backends.cudnn.allow_tf32 = False      # the plain versions' f32
    card = _common.card_line()
    libs = _build.load_all(
        [("fused_block0", bv.stage_defines(s)) for s in bv.STAGES]
        + [("fused_block0", bv.cut_defines(c)) for c in bv.CUTS])
    for name, lib in zip(list(bv.STAGES) + list(bv.CUTS), libs):
        print(f"{name:9s}: nvcc {lib.build_seconds:.1f} s, "
              f"{_common.kernel_resources(lib.log, 'block0_tc_kernel')}",
              flush=True)
    z, block, _, _ = _common.block0_case(BATCH, LENGTH)
    with torch.inference_mode():
        zs = z[:16]
        for stage in bv.STAGES:
            got = bv.fused_block0_stage(zs, block, stage)
            plain = bv.fused_block0_stage_reference(zs, block, stage)
            fault = _common.b0_fault(stage, zs, block)
            bad = fault and bv.fused_block0_stage(*fault, stage)
            text, fails = _common.b0_readings(stage, got, plain, bad)
            print(f"stage {stage:5s}: {text} (max|plain| "
                  f"{plain.float().abs().max().item():.3f})", flush=True)
            if fails:
                raise SystemExit("probe_b0_ablate: " + "; ".join(fails))
        fns = {f"stage {s}": (lambda s=s: bv.fused_block0_stage(z, block, s))
               for s in bv.STAGES}
        fns.update({f"cut {c}": (lambda c=c: bv.fused_block0_cut(z, block, c))
                    for c in bv.CUTS})
        runs = _common.two_runs(fns, args.iters)
    bounds = {f"stage {s}": _common.stage_bound(
        s, BATCH, LENGTH, block.conv1.out_channels, "bfloat16")
        for s in bv.STAGES}
    bounds.update(dict.fromkeys((f"cut {c}" for c in bv.CUTS)))
    _common.print_runs(BATCH, runs, 13, bounds, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
