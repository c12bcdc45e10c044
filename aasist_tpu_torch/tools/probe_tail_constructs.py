"""What block 0's tail costs alone: the max pool (1,3) in three
formulations and the SELU + layout-changing store, as kernels of their own
(``csrc/tail_constructs.cu``), beside stock PyTorch calls.

    python3 -m aasist_tpu_torch.tools.probe_tail_constructs  # one CUDA card

Counterpart of ``tools/probe_tail_constructs.py``.  bfloat16, at that
probe's sizes (B = 64, 32 channels, 23 rows, T = 4608) and at block 0's real
pre-pool size (B = 128, 32 x 23 x 21,489):

  pool direct / staged   ``ops.tail_constructs.pool3_time`` (``pool_reshape``
                         / ``pool_strided``), (B, 32, 23, T) -> (.., T // 3);
  pool time-major        ``pool3_time_major`` (``pool_sublane``),
                         (B, 32, T, 23) -> (B, 32, T // 3, 23);
  selu_to_nchw           (``geg_write``) (32, 24, B, T) -> (B, 32, 24, T),
                         a 16-byte vector a thread where T allows it, and
                         staged through shared memory;
  F.max_pool2d           the one PyTorch call that computes the pools;

and, at the first size only, that probe's XLA cases as stock PyTorch calls:
conv2 (``F.conv2d``, 32 -> 32, (2,3), padding (0,1)) on an NCHW input, on the
(32, 24, B, T) compute layout through a permuted view, and emitting
time-major output (conv + transpose copy), and the transpose (2,3) alone.

Each kernel is checked against its plain version first (the pools must be
exact).  Every line has ms per call over two runs, the input's rate in GB/s
and, for the kernels, the bound (the bytes read and written once).
"""

from __future__ import annotations

import argparse
import sys

from aasist_tpu_torch.tools import _common

CHANNELS = 32
F_Y = 23
SIZES = ((64, 4608), (128, 21489))      # (B, T before the pool)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    _common.need_card("probe_tail_constructs")

    import torch
    import torch.nn.functional as F

    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import tail_constructs as tc

    card = _common.card_line()
    lib = _build.load("tail_constructs")
    print(f"built tail_constructs.cu: nvcc {lib.build_seconds:.1f} s",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt, c, f = torch.bfloat16, CHANNELS, F_Y

    def rand(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.3).to(dt)

    def report(tag, fns, nbytes_in, bounds):
        for name, ms in _common.two_runs(fns, args.iters).items():
            bound = (f", bound {bounds[name]:.4f} ms (bytes)"
                     if name in bounds else "")
            print(f"{tag} bf16 {name:15s}: {sum(ms) / 2:8.4f} ms (runs "
                  f"{', '.join(f'{v:.4f}' for v in ms)}), "
                  f"{nbytes_in[name] / (sum(ms) / 2) / 1e6:6.0f} GB/s in"
                  f"{bound}  [{card}]", flush=True)

    with torch.inference_mode():
        for b, t in SIZES:
            tag = f"B={b} T={t}"
            v = t // 3
            # the pools over the last axis
            y = rand(b, c, f, t)
            ref = tc.pool3_time_reference(y)
            for how in tc.POOL_HOW:
                if not torch.equal(tc.pool3_time(y, how), ref):
                    raise SystemExit(f"probe_tail_constructs: pool {how} "
                                     f"differs from its plain version, {tag}")
            del ref
            pool_b = _common.bytes_bound(b * c * f * 3 * v, b * c * f * v,
                                         "bfloat16")[0]
            n_in = 2 * y.numel()
            report(tag, {
                "pool direct": lambda: tc.pool3_time(y, "direct"),
                "pool staged": lambda: tc.pool3_time(y, "staged"),
                "F.max_pool2d": lambda: F.max_pool2d(y, (1, 3)),
            }, {"pool direct": n_in, "pool staged": n_in,
                "F.max_pool2d": n_in},
                {"pool direct": pool_b, "pool staged": pool_b})
            if b == SIZES[0][0]:
                report(tag, {"xpose_wh": lambda: y.transpose(2, 3)
                             .contiguous()}, {"xpose_wh": n_in}, {})
            del y
            # the pool of a time-major tensor
            y = rand(b, c, t, f)
            if not torch.equal(tc.pool3_time_major(y),
                               tc.pool3_time_major_reference(y)):
                raise SystemExit("probe_tail_constructs: the time-major "
                                 f"pool differs from its plain version, "
                                 f"{tag}")
            report(tag, {"pool time-major": lambda: tc.pool3_time_major(y)},
                   {"pool time-major": n_in}, {"pool time-major": pool_b})
            del y
            # SELU + the layout change
            z = rand(c, f + 1, b, t)
            hows = [h for h in tc.SELU_HOW if h == "staged" or t % 8 == 0]
            ref = tc.selu_to_nchw_reference(z)
            for how in hows:
                if not torch.allclose(tc.selu_to_nchw(z, how).float(),
                                      ref.float(), atol=1e-6, rtol=2.0 ** -7):
                    raise SystemExit(
                        f"probe_tail_constructs: selu_to_nchw {how} is more "
                        f"than a bf16 ulp from its plain version, {tag}")
            del ref
            fns = {f"selu {how}": (lambda h=how: tc.selu_to_nchw(z, h))
                   for how in hows}
            selu_b = _common.bytes_bound(z.numel(), z.numel(), "bfloat16")[0]
            report(tag, {**fns, "plain selu+perm":
                         lambda: tc.selu_to_nchw_reference(z)},
                   dict.fromkeys([*fns, "plain selu+perm"], 2 * z.numel()),
                   dict.fromkeys(fns, selu_b))
            if b != SIZES[0][0]:
                del z
                torch.cuda.empty_cache()
                continue
            # conv2 on three layouts, stock calls
            w2 = rand(c, c, 2, 3)
            zn = z.permute(2, 0, 1, 3).contiguous()       # NCHW
            zv = z.permute(2, 0, 1, 3)                    # a view of CHNW

            def conv(inp):
                return F.conv2d(inp, w2, padding=(0, 1))
            report(tag, {
                "conv2_nchw": lambda: conv(zn),
                "conv2_chnw_in": lambda: conv(zv),
                "conv2_ncwh_out": lambda: conv(zn).transpose(2, 3)
                .contiguous(),
            }, dict.fromkeys(("conv2_nchw", "conv2_chnw_in",
                              "conv2_ncwh_out"), 2 * z.numel()), {})
            del z, zn, zv
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
