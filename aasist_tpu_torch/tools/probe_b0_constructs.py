"""Three constructs of the bf16 block-0 kernel switched one at a time:
builds of ``csrc/block0_pipe.cu`` with preprocessor definitions, checked and
timed on the card in turns with the same builds of the older kernel,
``csrc/fused_block0.cu``.

    python3 -m aasist_tpu_torch.tools.probe_b0_constructs   # one CUDA card

Counterpart of ``tools/probe_b0_constructs.py``.  B = 128, L = 64,600,
bfloat16, the pretrained AASIST's block 0 on the padded frontend's output
(full width, C = 32):

  none     the kernel as it is (``block0_pipe``, the stack path's);
  bf16epi  conv1's epilogue on packed bf16 pairs (``__nv_bfloat162``);
  rmw      conv2's per-tap partial sums accumulated by read-modify-write of
           an f32 tile in shared memory;
  b2slice  the bias read from shared memory at each use;
  all      the three together.

``ops.block0_variants.fused_block0_constructs`` runs them, and
``fused_block0_constructs_older`` the older kernel's builds ("<set> older"
below).  For each build it prints what ptxas reported for the kernel
(registers, spills), the error against the set's plain version on the first
16 rows (max error over max |plain|; for the bf16 epilogues also its
distance from the f32 epilogue's plain version and the reading of a planted
fault), and ms per batch over two runs, all builds in the same turns,
beside block 0's bound.  Then the phase timer of ``none`` and ``bf16epi``
(``B0P_TIMER`` builds, one launch each): whether the producers set the
pace shows in the consumers' wait for a full buffer, and the producers'
wait for an empty one.  A build that does not build or launch, or that
fails a gate (``tools/_common.py:b0_readings``, the gates of
``chip_smoke.py``), ends the run with an error.
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
TIMED_SETS = ("none", "bf16epi")       # the phase timer's question
OLDER = " older"                       # the older kernel's builds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    _common.need_card("probe_b0_constructs")

    import torch

    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import block0_pipe as bp
    from aasist_tpu_torch.ops import block0_variants as bv

    torch.backends.cudnn.allow_tf32 = False      # the plain versions' f32
    card = _common.card_line()
    fns = {"": bv.fused_block0_constructs,
           OLDER: bv.fused_block0_constructs_older}
    builds = {name + tag: bv.constructs_build(*flags, older=bool(tag))
              for tag in fns for name, flags in SETS.items()}
    timers = [("block0_pipe", {**bp.TIMER_DEFINES,
                               **(bv.constructs_defines(*SETS[n]) or {})})
              for n in TIMED_SETS]
    libs = _build.load_all(list(builds.values()) + timers)
    for (name, (src, _)), lib in zip(builds.items(), libs):
        kernel = "block0_pipe_kernel" if src == bv.PIPE_SOURCE \
            else "block0_tc_kernel"
        print(f"{name:15s}: nvcc {lib.build_seconds:.1f} s, "
              f"{_common.kernel_resources(lib.log, kernel)}", flush=True)
    z, block, bound, by = _common.block0_case(BATCH, LENGTH)
    with torch.inference_mode():
        zs = z[:16]
        plain_base = bv.fused_block0_constructs_reference(zs, block)
        for name, flags in SETS.items():
            plain = bv.fused_block0_constructs_reference(zs, block, *flags)
            for tag, fn in fns.items():
                got = fn(zs, block, *flags)
                bad = None
                if flags[0]:
                    bad = fn(*_common.b0_fault(name, zs, block), *flags)
                text, fails = _common.b0_readings(
                    name, got, plain, bad, plain_base if flags[0] else None)
                print(f"{name + tag:15s}: {text}", flush=True)
                if fails:
                    raise SystemExit("probe_b0_constructs: "
                                     + "; ".join(fails))
        runs = _common.two_runs(
            {name + tag: (lambda f=flags, fn=fn: fn(z, block, *f))
             for name, flags in SETS.items() for tag, fn in fns.items()},
            args.iters)
        _common.print_runs(BATCH, runs, 15, dict.fromkeys(runs, (bound, by)),
                           card)
        for name in TIMED_SETS:
            _, phases = bp.block0_timed(
                z, block, "pipe", bv.constructs_defines(*SETS[name]),
                bv.variant_bias(block))
            print(f"[phases] {name:8s} ms per CTA: " + ", ".join(
                f"{k} {v:.4f}" for k, v in phases.items()) + f"  [{card}]",
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
