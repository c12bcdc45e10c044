"""Time the formulations of the fused sinc frontend on the card.

    python3 -m aasist_tpu_torch.tools.probe_frontend_variants   # one card

Counterpart of ``tools/probe_frontend_variants.py``.  At B = 256 and
B = 128, L = 64,600, bfloat16, with CUDA events:

  v1      ``ops.fused_frontend.fused_frontend_fma``: the conv on the CUDA cores;
  dot_fm  ``ops.frontend_variants.fused_frontend_dot_fm``: the conv on the
          tensor cores, filter-major store (24, B, T);
  dot_bm  the same kernel, batch-major store (B, 24, T);
  plain   the PyTorch chain (``fused_frontend_reference``: cuDNN conv1d,
          abs, max_pool2d, BN, SELU),

each beside the frontend's bound.  The bank is the 70 x 129 sinc bank and
the BatchNorm a scale of 1 and a shift of 0.1, as in the TPU probe.

The TPU probe's ``glue`` variant times its host-side phase split
(``make_xt``); it has no counterpart, because the kernels here read the
waveform directly.  Its ``u4096`` / ``g16`` variants vary Mosaic's block
shape (G batch rows by u columns per grid step), which does not exist here
either: the kernel's tile is fixed in ``csrc/frontend_dot.cu``.
"""

from __future__ import annotations

import argparse
import sys

from aasist_tpu_torch.tools import _common

LENGTH = 64600
BATCHES = (256, 128)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    _common.need_card("probe_frontend_variants")

    import torch

    from aasist_tpu_torch.models.layers import sinc_filterbank
    from aasist_tpu_torch.ops import frontend_variants as fv
    from aasist_tpu_torch.ops.fused_frontend import (
        fused_frontend_fma, fused_frontend_reference)

    card = _common.card_line()
    dev, dt = "cuda", torch.bfloat16
    bank = torch.from_numpy(sinc_filterbank(70, 129, 16000)).to(dev, dt)
    one = lambda v: torch.tensor([v], device=dev, dtype=dt)
    bn_p, bn_s = ({"weight": one(1.0), "bias": one(0.1)},
                  {"mean": one(0.0), "var": one(1.0)})
    variants = {"v1": (fused_frontend_fma, None),
                "dot_fm": (fv.fused_frontend_dot_fm, fv.ROWS),
                "dot_bm": (fv.fused_frontend_dot_bm, fv.ROWS),
                "plain": (fused_frontend_reference, None)}
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in BATCHES:
        x = torch.randn((b, LENGTH), generator=gen, device=dev).to(dt)
        runs = {name: [] for name in variants}
        order = list(variants)
        for name in order + order[::-1]:        # each twice, in turns
            fn = variants[name][0]
            runs[name].append(_common.cuda_ms(
                lambda: fn(x, bank, bn_p, bn_s), args.iters))
        for name, (_, rows) in variants.items():
            bound, by = _common.frontend_bound(b, LENGTH, 70, "bfloat16",
                                               rows=rows)
            ms = sum(runs[name]) / len(runs[name])
            print(f"B={b:4d} {name:7s}: {ms:8.4f} ms (runs "
                  f"{', '.join(f'{v:.4f}' for v in runs[name])}), bound "
                  f"{bound:.4f} ms ({by})  [{card}]", flush=True)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
