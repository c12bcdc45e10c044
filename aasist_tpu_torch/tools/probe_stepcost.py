"""What a grid step of block 0's geometry costs on the card: empty, copy and
matrix kernels over the same steps (``csrc/stepcost.cu``).

    python3 -m aasist_tpu_torch.tools.probe_stepcost [--iters 5]

Counterpart of ``tools/probe_stepcost.py``: x (32, B = 128, 32, T = 7168)
bf16 (the JAX probe's default size), w (96, 64) bf16, one CTA per step of g
batch rows by u times, the six modes of ``ops.stepcost`` (nop, nopF32,
nopblk: constant stores; copy: 23 rows of x;
matmul, matblk: the dual-split dot on the tensor cores).  Sweeping (g, u)
tells whether a step has a fixed cost (the time follows the step count),
a byte cost (it follows the bytes) or a matrix-unit cost.  The sweep is the
JAX probe's seven (g, u) pairs, whose 448 to 28 steps fill at most a few
waves of the card's SMs, and two finer ones, (4, 256) and (1, 256), with
several CTAs to an SM.

The nop modes and copy store through TMA (``ops.stepcost.stepcost``); the
kernels they replaced, the ``STEPCOST_OLDER`` build
(``ops.stepcost.stepcost_older``), run beside them as "<mode> older".

First every mode of both builds is checked against its plain version at
every geometry (``tools/_common.py:stepcost_readings``: the output filled
with NaN before the launch, exact for the constant and copy modes, one bf16
ulp for the dots), and at the first geometry each mode's planted fault must
fail the gate; a failure ends the run with an error.  Then one line per
geometry and mode, both builds timed in the same turns: ms over two runs,
the CTA and SM counts, the bound (``_common.stepcost_bound``) and, for the
dots, TF/s on the FLOPs their function needs (``_common.stepcost_flops``);
then one stock PyTorch call per mode, timed the same way.
"""

from __future__ import annotations

import argparse
import sys

from aasist_tpu_torch.tools import _common

BATCH = 128                     # the JAX probe's default batch
T_TOTAL = 7168                  # ~ block 0's output width, as the JAX probe
GEOMETRIES = ((8, 256), (16, 256), (8, 512), (16, 512), (32, 512),
              (16, 1024), (32, 1024),          # the JAX probe's sweep
              (4, 256), (1, 256))              # several CTAs per SM


def inputs(batch: int, t_total: int, seed: int = 0):
    """(x, w) of the probe on the card: N(0, 1) rounded to bf16."""
    import torch

    from aasist_tpu_torch.ops import stepcost as sc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((sc.CHANNELS, batch, sc.ROWS, t_total), generator=gen,
                    device="cuda").bfloat16()
    w = torch.randn((sc.K, sc.M), generator=gen, device="cuda").bfloat16()
    return x, w


def check(mode: str, x, w, g: int, u: int, fault: bool, plain=None,
          fn=None):
    """(text, failures, max |kernel - plain|) of ``mode`` at steps (g, u)
    through ``fn`` (``ops.stepcost.stepcost`` or ``stepcost_older``; default
    the first) against its plain version (given, or computed), with the
    planted fault if ``fault``."""
    import torch

    from aasist_tpu_torch.ops import stepcost as sc

    fn = fn or sc.stepcost
    b, t = x.shape[1], x.shape[3]
    out = torch.full(sc.out_shape(mode, b, t, g, u), float("nan"),
                     dtype=torch.bfloat16, device=x.device)
    got = fn(mode, x, w, g, u, out=out)
    torch.cuda.synchronize()
    if plain is None:
        plain = sc.stepcost_reference(mode, x, w, g, u)
    bad = None
    if fault:
        bad = _common.stepcost_bad(
            mode, x, w, lambda xx, ww: fn(mode, xx, ww, g, u))
    text, fails = _common.stepcost_readings(mode, got, plain, bad)
    return text, fails, _common.max_abs_err(got, plain)


def library_calls(x, w):
    """{mode: fn}: one stock PyTorch call per mode computing the same
    values.  nop modes: ``fill_``; copy: the slice made contiguous; matmul,
    matblk: ``F.conv2d`` with a (4, 1) kernel whose taps are the two halves'
    weights summed (in f32, then rounded), on x permuted to NCHW, which is
    made here and is not timed."""
    import torch
    import torch.nn.functional as F

    from aasist_tpu_torch.ops import stepcost as sc

    c, b, _, t = x.shape
    wf = w.float()
    taps = torch.zeros((4, c, c), device=x.device)      # [tap, in, out]
    taps[:3] += wf[:, :c].reshape(3, c, c)
    taps[1:] += wf[:, c:].reshape(3, c, c)
    w4 = taps.permute(2, 1, 0)[..., None].to(x.dtype).contiguous()
    xn = x.permute(1, 0, 2, 3).contiguous()             # (B, 32, 32, T)
    out23 = torch.empty((c, b, sc.F, t), dtype=x.dtype, device=x.device)
    out32 = torch.empty((c, b, sc.ROWS, t), dtype=x.dtype, device=x.device)
    return {
        "nop": lambda: out23.fill_(1),
        "nopF32": lambda: out32.fill_(1),
        "nopblk": lambda: out32.fill_(1),
        "copy": lambda: x[:, :, :sc.F].contiguous(),
        "matmul": lambda: F.conv2d(xn[:, :, :sc.F + 3], w4),
        "matblk": lambda: F.conv2d(xn[:, :, :sc.F + 4], w4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    _common.need_card("probe_stepcost")

    import torch

    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import stepcost as sc

    card = _common.card_line()
    lib, older = _build.load_all([("stepcost", None),
                                  ("stepcost", sc.OLDER_DEFINES)])
    print(f"built stepcost.cu: nvcc {lib.build_seconds:.1f} s; gemm "
          f"{_common.kernel_resources(lib.log, 'gemm_kernel')}; TMA copy "
          f"{_common.kernel_resources(lib.log, 'copy_box_kernel')}; older "
          f"build {older.build_seconds:.1f} s", flush=True)
    builds = {"": sc.stepcost, " older": sc.stepcost_older}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b, t = BATCH, T_TOTAL
    x, w = inputs(b, t)
    with torch.inference_mode():
        fails = []
        for mode in sc.MODES:
            plain = (None if mode in ("nopblk", "matblk")
                     else sc.stepcost_reference(mode, x, w, 1, 8))
            for i, (g, u) in enumerate(GEOMETRIES):
                for tag, fn in builds.items():
                    if tag and mode not in sc.TMA_MODES:
                        continue            # the dots: one kernel in both
                    text, f, _ = check(mode, x, w, g, u, i == 0, plain, fn)
                    print(f"check {mode + tag:12s} G={g:3d} u={u:5d}: "
                          f"{text}", flush=True)
                    fails += f
            del plain
        if fails:
            raise SystemExit("probe_stepcost: " + "; ".join(fails))
        bounds = {m: _common.stepcost_bound(m, b, t) for m in sc.MODES}
        for g, u in GEOMETRIES:
            steps = (b // g) * (t // u)
            runs = _common.two_runs(
                {m + tag: (lambda m=m, fn=fn: fn(m, x, w, g, u))
                 for m in sc.MODES for tag, fn in builds.items()
                 if not tag or m in sc.TMA_MODES}, args.iters)
            for name, ms in runs.items():
                mode = name.split()[0]
                mean = sum(ms) / 2
                flops = _common.stepcost_flops(mode, b, t)
                rate = f", {flops / mean / 1e9:6.1f} TF/s" if flops else ""
                print(f"B={b} G={g:3d} u={u:5d} CTAs {steps:5d} on {sms} SMs"
                      f" {name:12s}: {mean:8.4f} ms (runs "
                      f"{', '.join(f'{v:.4f}' for v in ms)}), bound "
                      "{:.4f} ms ({}){}  [{}]".format(*bounds[mode], rate,
                                                      card), flush=True)
        lib_runs = _common.two_runs(library_calls(x, w), args.iters)
        for mode, ms in lib_runs.items():
            print(f"B={b} stock call for {mode:6s}: {sum(ms) / 2:8.4f} ms "
                  f"(runs {', '.join(f'{v:.4f}' for v in ms)}), bound "
                  "{:.4f} ms ({})  [{}]".format(*bounds[mode], card),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
