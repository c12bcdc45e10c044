"""Three constructs of the bf16 block-0 kernel switched one at a time:
builds of ``csrc/fused_block0.cu`` with preprocessor definitions, checked
and timed on the card.

    python3 -m aasist_tpu_torch.tools.probe_b0_constructs   # one CUDA card

Counterpart of ``tools/probe_b0_constructs.py``.  B = 128, L = 64,600,
bfloat16, the pretrained AASIST's block 0 on the padded frontend's output
(full width, C = 32):

  none     ``ops.fused_stack.fused_block0``'s kernel as it is;
  bf16epi  conv1's epilogue on packed bf16 pairs (``__nv_bfloat162``);
  rmw      conv2's per-tap partial sums accumulated by read-modify-write of
           an f32 tile in shared memory;
  b2slice  the bias read from shared memory at each use;
  all      the three together.

``ops.block0_variants.fused_block0_constructs`` runs them.  For each set it
prints what ptxas reported for the kernel (registers, spills), the error
against the set's plain version on the first 16 rows (max error over
max |plain|; for the bf16 epilogues also its distance from the f32
epilogue's plain version and the reading of a planted fault), and ms per
batch over two runs beside block 0's bound.  A set that does not build or
launch, or that fails a gate (``tools/_common.py:b0_readings``, the gates
of ``chip_smoke.py``), ends the run with an error.
"""

from __future__ import annotations

import argparse
import sys

from aasist_tpu_torch.tools import _common

LENGTH = 64600
BATCH = 128
SETS = {"none": (False, False, False), "bf16epi": (True, False, False),
        "rmw": (False, True, False), "b2slice": (False, False, True),
        "all": (True, True, True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    _common.need_card("probe_b0_constructs")

    import torch

    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import block0_variants as bv

    torch.backends.cudnn.allow_tf32 = False      # the plain versions' f32
    card = _common.card_line()
    libs = _build.load_all([("fused_block0", bv.constructs_defines(*f))
                            for f in SETS.values()])
    for name, lib in zip(SETS, libs):
        print(f"{name:8s}: nvcc {lib.build_seconds:.1f} s, "
              f"{_common.kernel_resources(lib.log, 'block0_tc_kernel')}",
              flush=True)
    z, block, bound, by = _common.block0_case(BATCH, LENGTH)
    with torch.inference_mode():
        zs = z[:16]
        plain_base = bv.fused_block0_constructs_reference(zs, block)
        for name, flags in SETS.items():
            got = bv.fused_block0_constructs(zs, block, *flags)
            plain = bv.fused_block0_constructs_reference(zs, block, *flags)
            bad = None
            if flags[0]:
                bad = bv.fused_block0_constructs(
                    *_common.b0_fault(name, zs, block), *flags)
            text, fails = _common.b0_readings(
                name, got, plain, bad, plain_base if flags[0] else None)
            print(f"{name:8s}: {text}", flush=True)
            if fails:
                raise SystemExit("probe_b0_constructs: " + "; ".join(fails))
        runs = _common.two_runs(
            {name: (lambda f=flags: bv.fused_block0_constructs(z, block, *f))
             for name, flags in SETS.items()}, args.iters)
    _common.print_runs(BATCH, runs, 8, dict.fromkeys(runs, (bound, by)),
                       card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
