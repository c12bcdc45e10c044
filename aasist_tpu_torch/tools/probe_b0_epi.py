"""Where conv1's epilogue rounds to bf16 in the block-0 kernel: five builds
of ``csrc/block0_pipe.cu``, checked and timed on the card in turns with the
same builds of the older kernel, ``csrc/fused_block0.cu``.

    python3 -m aasist_tpu_torch.tools.probe_b0_epi          # one CUDA card

Counterpart of ``tools/probe_b0_epi.py``.  B = 128, L = 64,600, bfloat16,
the pretrained AASIST's block 0 on the padded frontend's output:

  base  f32 through the shift and SELU, rounded once at the y1 store;
  vA    the f32 sum rounded at once; shift, SELU and halo mask on packed
        bf16 pairs; the downsample rounded and its bias added in bf16;
  vB    f32 SELU, rounded, the halo mask applied in bf16;
  vD    f32 SELU, the halo mask applied in f32, rounded;
  vF    vA with SELU's exponential taken in f32.

``ops.block0_variants.fused_block0_epi`` runs them, and
``fused_block0_epi_older`` the older kernel's builds ("<variant> older"
below).  It prints, on the first 16 rows, each build's error against its
plain version and its distance from its kernel's ``base`` (both max error
over max |.|; ``vB`` and ``vD`` must equal ``base`` bit for bit); for the
bf16 epilogues also the mean error against their own and against
``base``'s plain version (the nearer must be their own) and the error with
one conv1 tap of the block zeroed, the reading of a planted fault; then ms
per batch over two runs, all builds in the same turns, beside block 0's
bound.  A build that fails a gate (``tools/_common.py:b0_readings``, the
gates of ``chip_smoke.py``) ends the run with an error.
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
    _common.need_card("probe_b0_epi")

    import torch

    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import block0_variants as bv

    torch.backends.cudnn.allow_tf32 = False      # the plain versions' f32
    card = _common.card_line()
    fns = {"": bv.fused_block0_epi, OLDER: bv.fused_block0_epi_older}
    builds = {v + tag: bv.epi_build(v, older=bool(tag))
              for tag in fns for v in bv.EPI_VARIANTS}
    libs = _build.load_all(list(builds.values()))
    for (name, (src, _)), lib in zip(builds.items(), libs):
        kernel = "block0_pipe_kernel" if src == bv.PIPE_SOURCE \
            else "block0_tc_kernel"
        print(f"{name:11s}: nvcc {lib.build_seconds:.1f} s, "
              f"{_common.kernel_resources(lib.log, kernel)}", flush=True)
    z, block, bound, by = _common.block0_case(BATCH, LENGTH)
    with torch.inference_mode():
        zs = z[:16]
        plain_base = bv.fused_block0_epi_reference(zs, block, "base")
        for tag, fn in fns.items():
            base = fn(zs, block, "base")
            for name in bv.EPI_VARIANTS:
                got = fn(zs, block, name)
                plain = bv.fused_block0_epi_reference(zs, block, name)
                same = bool((got == base).all())
                bf16epi = name in _common.B0_BF16_EPILOGUES
                bad = None
                if bf16epi:
                    bad = fn(*_common.b0_fault(name, zs, block), name)
                text, fails = _common.b0_readings(
                    name, got, plain, bad, plain_base if bf16epi else None)
                print(f"{name + tag:11s}: {text}; distance from base "
                      f"{_common.rel_err(got, base):.3e}"
                      f"{' (bit for bit)' if same else ''}", flush=True)
                if name in ("vB", "vD") and not same:
                    fails.append(f"{name + tag} differs from base")
                if fails:
                    raise SystemExit("probe_b0_epi: " + "; ".join(fails))
        runs = _common.two_runs(
            {name + tag: (lambda v=name, fn=fn: fn(z, block, v))
             for name in bv.EPI_VARIANTS for tag, fn in fns.items()},
            args.iters)
    _common.print_runs(BATCH, runs, 11, dict.fromkeys(runs, (bound, by)),
                       card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
