"""Where the frontend + block-0 head kernel's time goes: compile-time
variants of ``csrc/frontend_head_pipe.cu``, timed on the card in turns with
the same variants of the kernel it replaced, ``csrc/frontend_head.cu``.

    python3 -m aasist_tpu_torch.tools.probe_feb0_ablate    # one CUDA card

Counterpart of ``tools/probe_feb0_ablate.py``.  B = 128, L = 64,600,
bfloat16, the pretrained AASIST's frontend and block 0, CUDA events, ms per
batch, beside the head's bound (the bytes it writes):

  base     ``ops.frontend_head.fused_frontend_head`` as it is (y1 channels
           last; "base older" is ``fused_frontend_head_older``, NCHW);
  noselu   y1 stored without its SELU (isolates the exp);
  bf16acc  conv1 accumulated in bf16 with ``__hfma2`` (the TPU probe's
           ``bf16dot``, which Mosaic refused; the card compiles it);
  nodot    no conv1: x0 broadcast to the 32 channels, the frontend plus the
           write floor;
  half, quarter, double  the base kernel with a frame tile half, a
           quarter and twice as wide, where the source can build it (new:
           half and quarter, 256 / 128 columns instead of 512, whose twice
           does not fit in shared memory; older: half and double, 160 / 640
           instead of 320); the TPU probe's u512 / u2048.

Each name is a build of each source with preprocessor definitions ("<name>
older" the older source's); all are built together and timed in the same
turns.  Only ``base`` is a function of the package.

Before the times it prints, on the first 16 rows, how far y1 stands from the
plain bfloat16 chain (max error over max |plain|) and from conv1 + bn2 + SELU
in float32 on the kernel's own x0 (worst element over its tolerance, at most
1 where the gate holds), for ``base``, ``half``, ``quarter`` and
``bf16acc`` of the new kernel, ``base older``, and ``base`` given a block
whose conv1 has one tap zeroed: sound kernels, a coarser one and a planted
fault, the readings ``chip_smoke.py``'s gates on y1 are set between.
"""

from __future__ import annotations

import argparse
import copy
import sys

from aasist_tpu_torch.tools import _common

LENGTH = 64600
BATCH = 128
OLDER = " older"
# name: (the definitions of csrc/frontend_head_pipe.cu, of
# csrc/frontend_head.cu; False where that source has no such build)
VARIANTS = {
    "base": (None, None),
    "noselu": ({"HEADP_NOSELU": None}, {"HEAD_NOSELU": None}),
    "bf16acc": ({"HEADP_BF16ACC": None}, {"HEAD_BF16ACC": None}),
    "nodot": ({"HEADP_NODOT": None}, {"HEAD_NODOT": None}),
    "half": ({"HEADP_SUB": 4}, {"HEAD_WARPS_T": 1}),
    "quarter": ({"HEADP_SUB": 2}, False),
    "double": (False, {"HEAD_WARPS_T": 4}),
}
CHECKED = ("base", "half", "quarter", "bf16acc")


def builds():
    """{name: (source, definitions)} of every build the probe runs."""
    from aasist_tpu_torch.ops import frontend_head as fh

    out = {}
    for name, (new, old) in VARIANTS.items():
        if new is not False:
            out[name] = (fh.SOURCE, new)
        if old is not False:
            out[name + OLDER] = (fh.OLDER_SOURCE, old)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    _common.need_card("probe_feb0_ablate")

    import torch

    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import frontend_head as fh

    card = _common.card_line()
    every = builds()
    libs = _build.load_all(list(every.values()))
    print(f"built {len(libs)} variants of frontend_head_pipe.cu and "
          f"frontend_head.cu: nvcc "
          f"{', '.join(f'{lib.build_seconds:.1f}' for lib in libs)} s",
          flush=True)
    model, bank, bn_p, bn_s = _common.pretrained(torch.bfloat16)
    block = model.encoder[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((BATCH, LENGTH), generator=gen, device="cuda")
         * 0.3).bfloat16()
    bound, by = _common.head_bound(BATCH, LENGTH, bank.shape[0],
                                   "bfloat16")

    def run(name, xs=x, blk=block):
        if name == "base":
            return lambda: fh.fused_frontend_head(xs, bank, bn_p, bn_s, blk)
        if name == "base" + OLDER:
            return lambda: fh.fused_frontend_head_older(xs, bank, bn_p, bn_s,
                                                        blk)
        src, defines = every[name]
        return lambda: fh.launch(xs, bank, bn_p, bn_s, blk, defines, src)

    with torch.inference_mode():
        xs = x[:16]
        plain = fh.fused_frontend_head_reference(xs, bank, bn_p, bn_s,
                                                 block)[0].float()
        faulty = copy.deepcopy(block)
        faulty.conv1.weight[:, 0, 0, 0] = 0
        cases = {name: (name, block) for name in CHECKED}
        cases["base" + OLDER] = ("base" + OLDER, block)
        cases["base, conv1 tap (0,0) zeroed"] = ("base", faulty)
        tol = _common.HEAD_Y1_OWN_X0_TOL
        for label, (name, blk) in cases.items():
            y1, x0 = run(name, xs, blk)()
            rel = ((y1.float() - plain).abs().max() / plain.abs().max()
                   ).item()
            excess = _common.head_y1_excess(y1, x0, block, **tol)
            print(f"y1 error, {label}: / max|plain| {rel:.3e}; worst element "
                  f"over (atol {tol['atol']}, rtol {tol['rtol']:.3e}) of the "
                  f"f32 head of its own x0: {excess:.3e}", flush=True)
        del plain, y1, x0

        runs = _common.two_runs({name: run(name) for name in every},
                                args.iters)
    for name in every:
        print(f"B={BATCH} bf16 {name:14s}: {sum(runs[name]) / 2:8.4f} "
              f"ms/batch (runs "
              f"{', '.join(f'{v:.4f}' for v in runs[name])}), bound "
              f"{bound:.4f} ms ({by})  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
