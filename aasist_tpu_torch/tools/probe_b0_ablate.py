"""Where the bf16 block-0 kernel's time goes: the kernel cut after each of
six cumulative stages, each stage checked against a plain version, and the
kernel with one phase removed at a time, on ``csrc/block0_pipe.cu`` in
turns with the same builds of the older kernel, ``csrc/fused_block0.cu``.

    python3 -m aasist_tpu_torch.tools.probe_b0_ablate       # one CUDA card

Counterpart of ``tools/probe_b0_ablate.py``.  B = 128, L = 64,600, bfloat16,
the pretrained AASIST's block 0 on the padded frontend's output.  Builds of
both sources with preprocessor definitions, all built together.

Stages (``ops.block0_variants.fused_block0_stage``, and
``fused_block0_stage_older`` for the older kernel, "<stage> older" below;
the module states each stage's function).  A stage ends the work item after
its phase and reduces what it computed into the output tile, so no work is
dead code, and its output is held against the stage's plain version on the
first 16 rows (max error over max |plain|; sums of up to 18 terms; stages
``dma`` .. ``epi`` also in the mean, with the reading of a planted fault
beside it).  A stage that fails a gate (``tools/_common.py:b0_readings``,
the gates of ``chip_smoke.py``) ends the run with an error.  Each stage's
time stands beside the bound of what that stage must do
(``_common.stage_bound``):

  dma < fill < conv1 < epi < conv2 < full

One phase removed (``ops.block0_variants.fused_block0_cut`` and
``fused_block0_cut_older``; the output is undefined, only the time is read,
and there is no bound): the frame-tile load (on ``block0_pipe.cu`` the
producers' issue of the next tile), conv1 + SELU, conv2's MMA loop, the
output store (``no_epi``; the pool and downsample are still computed), and
all four (the persistent loop, its barriers and the weight loads).  The
older kernel runs an item's phases one after another between barriers, the
new one overlaps its producers' and consumers', so on neither do the cuts
add up.  Last, the phase timer of the whole new kernel (``B0P_TIMER``, one
launch, ms per CTA) beside the ``no_load`` cut: what the producers' issue of
the next frame tile costs the CTA, and what removing it saves end to end.
"""

from __future__ import annotations

import argparse
import sys

from aasist_tpu_torch.tools import _common

LENGTH = 64600
BATCH = 128
OLDER = " older"                       # the older kernel's builds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    _common.need_card("probe_b0_ablate")

    import torch

    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import block0_pipe as bp
    from aasist_tpu_torch.ops import block0_variants as bv

    torch.backends.cudnn.allow_tf32 = False      # the plain versions' f32
    card = _common.card_line()
    stage_fns = {"": bv.fused_block0_stage, OLDER: bv.fused_block0_stage_older}
    cut_fns = {"": bv.fused_block0_cut, OLDER: bv.fused_block0_cut_older}
    builds = {f"stage {s}{tag}": bv.stage_build(s, older=bool(tag))
              for s in bv.STAGES for tag in stage_fns}
    builds.update({f"cut {c}{tag}": bv.cut_build(c, older=bool(tag))
                   for c in bv.CUTS for tag in cut_fns})
    libs = _build.load_all(list(builds.values())
                           + [("block0_pipe", bp.TIMER_DEFINES)])
    for (name, (src, _)), lib in zip(builds.items(), libs):
        kernel = "block0_pipe_kernel" if src == bv.PIPE_SOURCE \
            else "block0_tc_kernel"
        print(f"{name:22s}: nvcc {lib.build_seconds:.1f} s, "
              f"{_common.kernel_resources(lib.log, kernel)}", flush=True)
    z, block, _, _ = _common.block0_case(BATCH, LENGTH)
    with torch.inference_mode():
        zs = z[:16]
        for stage in bv.STAGES:
            plain = bv.fused_block0_stage_reference(zs, block, stage)
            fault = _common.b0_fault(stage, zs, block)
            for tag, fn in stage_fns.items():
                got = fn(zs, block, stage)
                bad = fault and fn(*fault, stage)
                text, fails = _common.b0_readings(stage, got, plain, bad)
                print(f"stage {stage + tag:11s}: {text} (max|plain| "
                      f"{plain.float().abs().max().item():.3f})", flush=True)
                if fails:
                    raise SystemExit("probe_b0_ablate: " + "; ".join(fails))
        fns = {f"stage {s}{tag}": (lambda s=s, fn=fn: fn(z, block, s))
               for s in bv.STAGES for tag, fn in stage_fns.items()}
        fns.update({f"cut {c}{tag}": (lambda c=c, fn=fn: fn(z, block, c))
                    for c in bv.CUTS for tag, fn in cut_fns.items()})
        runs = _common.two_runs(fns, args.iters)
        _, phases = bp.block0_timed(z, block, "pipe")
    bounds = {f"stage {s}{tag}": _common.stage_bound(
        s, BATCH, LENGTH, block.conv1.out_channels, "bfloat16")
        for s in bv.STAGES for tag in stage_fns}
    bounds.update(dict.fromkeys(f"cut {c}{tag}" for c in bv.CUTS
                                for tag in cut_fns))
    _common.print_runs(BATCH, runs, 22, bounds, card)
    full, no_load = (sum(runs[k]) / 2 for k in ("stage full", "cut no_load"))
    print(f"[phases] block0_pipe, one launch, ms per CTA: " + ", ".join(
        f"{k} {v:.4f}" for k, v in phases.items()) + f"; the kernel "
        f"{full:.4f} ms a batch, without the frame-tile issue (no_load) "
        f"{no_load:.4f}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
