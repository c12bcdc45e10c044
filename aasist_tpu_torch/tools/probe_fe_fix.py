"""Does the tensor-core frontend coexist with block 0's stock convolutions?

    python3 -m aasist_tpu_torch.tools.probe_fe_fix      # one CUDA card

Counterpart of ``tools/probe_fe_fix.py``, with the pretrained AASIST in
bfloat16.  The TPU probe looked for a frontend formulation whose output the
compiler's convs could read without a transpose (its batch-major ``v2bm``
kernel).  On this card the same question reads: does cuDNN take the
batch-major kernel's strided view ``out[:, None, :23]`` without a copy, and
what does the filter-major layout's transpose cost.  It prints:

  (a) max |dot_bm - plain frontend| on a seeded (8, 64600) input (the plain
      bf16 chain rounds three times, the kernel once: an ulp or two, held
      to 2e-2 absolute plus 2e-2 relative), and against v1, for the
      ``wgmma`` kernel (``csrc/frontend_dot_wg.cu``) and for the one before
      it, ``fused_frontend_dot_bm_older`` (``csrc/frontend_dot.cu``);
  (b) frontend + block 0 (the stock ``ResidualBlock``: cuDNN convs, BN,
      SELU, pool) + sum, timed with CUDA events for
        v1      ``fused_frontend_fma``, the CUDA-core kernel (contiguous
                (B, 1, 23, T)),
        dot_bm  ``fused_frontend_dot_bm``, passed as the strided view,
        dot_fm  ``fused_frontend_dot_fm`` after ``permute`` + ``contiguous``,
      and block 0 alone on the contiguous tensor and on the view;
  (c) K = 1 against K = 5 back-to-back ``dot_bm`` launches: the slope, in
      ms per launch, is the kernel's time free of per-call overhead; the
      same for ``dot_bm_older``.
"""

from __future__ import annotations

import argparse
import sys

from aasist_tpu_torch.tools import _common

LENGTH = 64600
BATCH = 256
TOL = dict(atol=2e-2, rtol=2e-2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    _common.need_card("probe_fe_fix")

    import numpy as np
    import torch

    from aasist_tpu_torch.ops import frontend_variants as fv
    from aasist_tpu_torch.ops.fused_frontend import (
        fused_frontend_fma, fused_frontend_reference)

    card = _common.card_line()
    model, bank, bn_p, bn_s = _common.pretrained(torch.bfloat16)
    block = model.encoder[0]
    f_out = bank.shape[0] // 3

    with torch.inference_mode():
        # (a)
        xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (8, LENGTH)).astype(np.float32)).to("cuda", torch.bfloat16)
        ref = fused_frontend_reference(xs, bank, bn_p, bn_s).float()
        v1 = fused_frontend_fma(xs, bank, bn_p, bn_s).float()
        for name, fn in (("dot_bm", fv.fused_frontend_dot_bm),
                         ("dot_bm_older", fv.fused_frontend_dot_bm_older)):
            got = fn(xs, bank, bn_p, bn_s)[:, None, :f_out].float()
            err = (got - ref).abs().max().item()
            d_v1 = (got - v1).abs().max().item()
            print(f"{name} err vs the plain frontend, (8, {LENGTH}): "
                  f"{err:.3e} (max |plain| {ref.abs().max().item():.3e}); "
                  f"vs v1 {d_v1:.3e}", flush=True)
            if not torch.allclose(got, ref, **TOL):
                print(f"probe_fe_fix: {name} is outside {TOL} of the plain "
                      "frontend", file=sys.stderr)
                return 1

        # (b)
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = (torch.randn((BATCH, LENGTH), generator=gen, device="cuda")
             * 0.1).bfloat16()
        view = lambda: fv.fused_frontend_dot_bm(
            x, bank, bn_p, bn_s)[:, None, :f_out]
        chains = {
            "v1": lambda: block(fused_frontend_fma(x, bank, bn_p, bn_s)).sum(),
            "dot_bm": lambda: block(view()).sum(),
            "dot_fm": lambda: block(fv.fused_frontend_dot_fm(
                x, bank, bn_p, bn_s).permute(1, 0, 2)[:, None, :f_out]
                .contiguous()).sum(),
        }
        h_view = view()
        h_cont = h_view.contiguous()
        chains["block0 on contiguous"] = lambda: block(h_cont).sum()
        chains["block0 on the view"] = lambda: block(h_view).sum()
        vals = {name: float(fn()) for name, fn in chains.items()}
        order = list(chains)
        runs = {name: [] for name in chains}
        for name in order + order[::-1]:
            runs[name].append(_common.cuda_ms(chains[name], args.iters))
        for name in order:
            print(f"B={BATCH} {name:21s}: "
                  f"{sum(runs[name]) / 2:8.4f} ms (runs "
                  f"{', '.join(f'{v:.4f}' for v in runs[name])}), sum "
                  f"{vals[name]:.4e}  [{card}]", flush=True)
        print(f"the view: shape {tuple(h_view.shape)}, strides "
              f"{h_view.stride()}, contiguous {h_view.is_contiguous()}",
              flush=True)

        # (c)
        def back_to_back(dot, k):
            def fn():
                for _ in range(k):
                    dot(x, bank, bn_p, bn_s)
            return fn
        for name, dot in (("dot_bm", fv.fused_frontend_dot_bm),
                          ("dot_bm_older", fv.fused_frontend_dot_bm_older)):
            t1 = _common.cuda_ms(back_to_back(dot, 1), args.iters)
            t5 = _common.cuda_ms(back_to_back(dot, 5), args.iters)
            print(f"B={BATCH} {name} chained: K=1 {t1:.4f} ms, K=5 "
                  f"{t5:.4f} ms, slope {(t5 - t1) / 4:.4f} ms per launch  "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
