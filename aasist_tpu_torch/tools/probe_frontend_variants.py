"""Time the formulations of the fused sinc frontend on the card.

    python3 -m aasist_tpu_torch.tools.probe_frontend_variants   # one card

Counterpart of ``tools/probe_frontend_variants.py``.  At B = 256 and
B = 128, L = 64,600, bfloat16, with CUDA events:

  v1            ``ops.fused_frontend.fused_frontend_fma``: the conv on the
                CUDA cores;
  dot_fm        ``ops.frontend_variants.fused_frontend_dot_fm``: the conv on
                the tensor cores' ``wgmma`` (``csrc/frontend_dot_wg.cu``),
                filter-major store (24, B, T);
  dot_bm        the same kernel, batch-major store (B, 24, T);
  dot_fm_older  ``fused_frontend_dot_fm_older``, the kernel before it on
  dot_bm_older  ``mma.sync`` (``csrc/frontend_dot.cu``), in both layouts;
  plain         the PyTorch chain (``fused_frontend_reference``: cuDNN
                conv1d, abs, max_pool2d, BN, SELU),

each beside the frontend's bound.  The bank is the 70 x 129 sinc bank and
the BatchNorm a scale of 1 and a shift of 0.1, as in the TPU probe.

Then, at B = 128, the builds of ``csrc/frontend_dot_wg.cu`` (``builds()``,
its header says what each switches), filter-major, timed in turns: the
default and the timing-only cuts ``one_window`` (one pooled window of a
lane's twelve), ``no_store`` (no global stores) and
``one_window_no_store`` (both: the tile loads, the MMAs and a one-window
epilogue), whose output is not the function.  The default is held to the
plain version (2e-2 absolute plus 2e-2 relative, ``chip_smoke.py``'s bf16
kernel gate); the probe exits non-zero when it misses it.

The TPU probe's ``glue`` variant times its host-side phase split
(``make_xt``); it has no counterpart, because the kernels here read the
waveform directly.  Its ``u4096`` / ``g16`` variants vary Mosaic's block
shape (G batch rows by u columns per grid step), which does not exist here
either: the kernels' tiles are fixed in their sources.
"""

from __future__ import annotations

import argparse
import functools
import sys

from aasist_tpu_torch.tools import _common

LENGTH = 64600
BATCHES = (256, 128)
TOL = dict(atol=2e-2, rtol=2e-2)
# csrc/frontend_dot_wg.cu's builds: name -> (definitions, checked)
WG_BUILDS = {"base": (None, True),
             "one_window": ({"FDW_CUT": 1}, False),
             "no_store": ({"FDW_CUT": 2}, False),
             "one_window_no_store": ({"FDW_CUT": 3}, False)}


def builds():
    """Every build the probe times, by name: (source, definitions)."""
    from aasist_tpu_torch.ops import frontend_variants as fv

    return {name: (fv.SOURCE, d) for name, (d, _) in WG_BUILDS.items()}


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
                "dot_fm_older": (fv.fused_frontend_dot_fm_older, fv.ROWS),
                "dot_bm_older": (fv.fused_frontend_dot_bm_older, fv.ROWS),
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
            print(f"B={b:4d} {name:12s}: {ms:8.4f} ms (runs "
                  f"{', '.join(f'{v:.4f}' for v in runs[name])}), bound "
                  f"{bound:.4f} ms ({by})  [{card}]", flush=True)
        del x

    # the wgmma kernel's builds, filter-major at B = 128
    from aasist_tpu_torch.ops import _build

    b = BATCHES[-1]
    x = torch.randn((b, LENGTH), generator=gen, device=dev).to(dt)
    ref = fv.fused_frontend_dot_fm_reference(x, bank, bn_p, bn_s).float()
    _build.load_all(list(builds().values()))
    runs = {name: [] for name in WG_BUILDS}
    launch = {name: functools.partial(fv._launch, f"probe {name}", x, bank,
                                      bn_p, bn_s, "fm", src, d)
              for name, (src, d) in builds().items()}
    failed = []
    for name, (_, checked) in WG_BUILDS.items():
        if checked:
            got = launch[name]().float()
            err = (got - ref).abs().max().item()
            ok = torch.allclose(got, ref, **TOL)
            print(f"B={b:4d} build {name:19s}: max|kernel-plain| {err:.3e}"
                  f"{'' if ok else ' FAILS ' + str(TOL)}", flush=True)
            if not ok:
                failed.append(name)
    order = list(WG_BUILDS)
    for name in order + order[::-1]:
        runs[name].append(_common.cuda_ms(launch[name], args.iters))
    bound, by = _common.frontend_bound(b, LENGTH, 70, "bfloat16",
                                       rows=fv.ROWS)
    for name in order:
        ms = sum(runs[name]) / len(runs[name])
        print(f"B={b:4d} build {name:19s}: {ms:8.4f} ms (runs "
              f"{', '.join(f'{v:.4f}' for v in runs[name])}), bound "
              f"{bound:.4f} ms ({by})  [{card}]", flush=True)
    if failed:
        print(f"probe_frontend_variants: {failed} outside {TOL} of the "
              "plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
