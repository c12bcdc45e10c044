"""What the tensor cores give at the fused kernels' dot shapes on the card:
n chained dots on resident operands (``csrc/mma_shapes.cu``, ``mma.sync``).

    python3 -m aasist_tpu_torch.tools.probe_mxu_shapes [--iters 5]

Counterpart of ``tools/probe_mxu_shapes.py``: for each (K, M) of
``ops.mma_shapes.SHAPES``, w (K, M) and a (K, 2048)
bf16, and ``mma_chain``'s loop y = w^T a, a[0] += bf16(eps sum_m y^2), one
CTA per SM on its own 16 columns of a.  The shapes:

  k132_m210  frontend dot (3 x 44 taps)     k144_m630  one-dot frontend
  k192_m32   tap-stacked C = 32 conv2       k384_m96   shift-enumerated conv2
  k384_m64   tap-stacked C = 64 conv2       k128_m128  square baseline
  k256_m256  bigger baseline                k12_m192   block-0 conv1 + ds,
  k96_m96, k96_m192, k192_m96, k192_m64     K-starved

First every shape is checked against its plain version at a visible eps
(``tools/_common.py:mma_readings``; w with one K row zeroed must fail the
gate); a failure ends the run with an error.  Then, as the JAX probe does,
the kernel is timed at n and 2 n dots (CUDA events) and the difference
divided by n: us a dot, TF/s on the useful 2 K M N FLOP and on the padded
ones (K and M to multiples of 16), the share of 989 TF/s (the H100's dense
bf16 peak), beside one ``torch.mm(w.t(), a)`` a dot (timed in a CUDA graph
of 50 calls: alone it takes less than the host needs to launch it) and the
plain version's time a dot (the n-against-2 n difference at n = 10; its
Python loop is host-bound).  n is 1000 (``N_DOTS``), not the JAX probe's 50:
a launch must run well past the host's ~40 us a call, or the difference is
noise (on an H100 at n = 50 two shapes read negative).
"""

from __future__ import annotations

import argparse
import sys

from aasist_tpu_torch.tools import _common

N_DOTS = 1000          # dots a timed launch chains (and twice as many)
N_PLAIN = 10           # the same for the plain version's host-bound loop
MM_REPS = 50           # torch.mm calls in the timed CUDA graph


def inputs(k: int, m: int, n_cols: int, seed: int = 0):
    """(w, a) N(0, 1) in bf16 on the card: the check's inputs."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((k, m), generator=gen, device="cuda").bfloat16()
    a = torch.randn((k, n_cols), generator=gen, device="cuda").bfloat16()
    return w, a


def check(name: str):
    """(text, failures, max |kernel - plain|) of shape ``name`` against its
    plain version at the visible eps, with the planted fault."""
    import torch

    from aasist_tpu_torch.ops import mma_shapes as ms

    k, m = ms.SHAPES[name]
    w, a = inputs(k, m, ms.N_COLS)
    eps, n = _common.mma_eps(k, m), _common.MMA_CHECK_ITERS
    got = ms.mma_chain(w, a, n, eps)
    torch.cuda.synchronize()
    plain = ms.mma_chain_reference(w, a, n, eps)
    bad = _common.mma_bad(w, a, lambda ww, aa: ms.mma_chain(ww, aa, n, eps))
    text, fails = _common.mma_readings(name, got, plain, a, bad)
    return text, fails, _common.max_abs_err(got, plain)


def per_dot_ms(fn, n: int, iters: int) -> float:
    """ms a dot: ``fn(2 n)`` less ``fn(n)``, over n (CUDA events)."""
    return (_common.cuda_ms(lambda: fn(2 * n), iters)
            - _common.cuda_ms(lambda: fn(n), iters)) / n


def measure(name: str, n: int, iters: int):
    """{ms, plain_ms, library_ms, bound_ms, bound_by, tflops,
    tflops_padded} a dot of shape ``name``, on the JAX probe's inputs (w
    all 1e-3, a all 1) at its eps."""
    import torch

    from aasist_tpu_torch.ops import mma_shapes as ms

    k, m = ms.SHAPES[name]
    w = torch.full((k, m), 1e-3, device="cuda").bfloat16()
    a = torch.ones((k, ms.N_COLS), device="cuda").bfloat16()
    per = per_dot_ms(lambda nn: ms.mma_chain(w, a, nn), n, iters)
    plain = per_dot_ms(lambda nn: ms.mma_chain_reference(w, a, nn),
                       N_PLAIN, max(1, iters // 2))
    wt = w.t()
    lib = _common.graph_ms(lambda: torch.mm(wt, a), MM_REPS, iters)
    kp, mp = ms.padded(k, m)
    bound, by = _common.mma_chain_bound(k, m, ms.N_COLS)
    return dict(ms=per, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by=by, tflops=2.0 * k * m * ms.N_COLS / per / 1e9,
                tflops_padded=2.0 * kp * mp * ms.N_COLS / per / 1e9,
                library_tflops=2.0 * k * m * ms.N_COLS / lib / 1e9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    _common.need_card("probe_mxu_shapes")

    import torch

    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import mma_shapes as ms

    card = _common.card_line()
    lib = _build.load("mma_shapes")
    print(f"built mma_shapes.cu: nvcc {lib.build_seconds:.1f} s; chain "
          f"{_common.kernel_resources(lib.log, 'chain_kernel')}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = -(-ms.N_COLS // ms.COLS_PER_CTA)
    peak = _common.PEAK_FLOPS["bfloat16"] / 1e12
    with torch.inference_mode():
        fails = []
        for name in ms.SHAPES:
            text, f, _ = check(name)
            print(f"check {name:9s}: {text}", flush=True)
            fails += f
        if fails:
            raise SystemExit("probe_mxu_shapes: " + "; ".join(fails))
        for name in ms.SHAPES:
            r = measure(name, N_DOTS, args.iters)
            print(f"{name:9s}: {1e3 * r['ms']:8.3f} us/dot -> "
                  f"{r['tflops']:6.1f} TF/s ({100 * r['tflops'] / peak:4.1f}%"
                  f" of {peak:.0f}), padded {r['tflops_padded']:6.1f} TF/s; "
                  f"bound {1e3 * r['bound_ms']:.3f} us ({r['bound_by']}); "
                  f"torch.mm {1e3 * r['library_ms']:.3f} us "
                  f"({r['library_tflops']:.1f} TF/s); plain "
                  f"{1e3 * r['plain_ms']:.3f} us/dot; n = {N_DOTS}, {ctas} "
                  f"CTAs on {sms} SMs  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
