"""Where the bf16 block-0 kernel's time goes: one phase removed at a time.

    python3 -m aasist_tpu_torch.tools.ablate_block0     # one CUDA card

Builds copies of ``csrc/fused_block0.cu`` in which one phase of the bf16
kernel (``block0_tc_kernel``) is cut out, and times each copy at the main
path's shape, (128, 64600) in bf16 on the padded frontend's output, with
CUDA events:

  full      the kernel as it is;
  no_mma    conv2's tensor-core loop removed;
  no_conv1  the y1 tile left unbuilt (conv1 + SELU removed);
  no_epi    the pool, downsample and store removed (dead code, so the
            compiler drops the work feeding them);
  no_load   the frame tile left unloaded;
  only_loop all four removed: the persistent loop, its barriers and the
            weight loads.

The copies compute nothing useful; only their times are read.  Prints one
line per copy and run, and the card's name, power limit and SM clock.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# (text in block0_tc_kernel, its replacement) for each cut
CUTS = {
    "mma": ("for (int tap = 0; tap < 6; ++tap) {",
            "for (int tap = 0; tap < 0; ++tap) {"),
    "conv1": ("run < (R + 1) * (YW / RUN);", "run < 0;"),
    "epi": ("if (q0 + 8 * u < T_out)", "if (q0 + 8 * u < 0)"),
    "load": ("load_frame_tile<R>(zs, z, it, F, T_z);", ";"),
}
VARIANTS = {"full": (), "no_mma": ("mma",), "no_conv1": ("conv1",),
            "no_epi": ("epi",), "no_load": ("load",),
            "only_loop": ("mma", "conv1", "epi", "load")}


def variant_source(src: str, cuts) -> str:
    start = src.index("block0_tc_kernel(")
    for cut in cuts:
        old, new = CUTS[cut]
        i = src.index(old, start)
        src = src[:i] + new + src[i + len(old):]
    return src


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import fused_stack as fs
    from aasist_tpu_torch.tools import _common

    _common.need_card("ablate_block0")

    src = (_build.CSRC / "fused_block0.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablate_block0"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, cuts))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"ablate_block0: nvcc failed for {name}:\n{log}")

    model, bank, bn_p, bn_s = _common.pretrained(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((128, 64600), generator=gen, device="cuda")
         * 0.1).bfloat16()
    with torch.inference_mode():
        z = fs.fused_frontend_padded(x, bank, bn_p, bn_s)
        for run in range(2):
            for name in VARIANTS:
                lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
                _build._loaded[("fused_block0", ())] = _build.Library(
                    lib, out_dir / f"{name}.so", 0.0, "")
                fn = lambda: fs.fused_block0(z, model.encoder[0])
                fn()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(5):
                    fn()
                end.record()
                torch.cuda.synchronize()
                print(f"run {run} {name:9s} {start.elapsed_time(end) / 5:.4f}"
                      " ms", flush=True)
    _build._loaded.pop(("fused_block0", ()))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
