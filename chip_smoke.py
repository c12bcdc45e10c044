#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which raises (exit code 1) on failure:
  1. versions, the card's name and power limit; TF32 off for the f32 checks;
  2. build the eight CUDA sources from csrc/, the eighteen variants of
     fused_block0.cu (its timer build among them) and the four of
     block0_pipe.cu (timer, three timing cuts) with nvcc, all at once;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shape (128, 64600) in float32 and bfloat16 and at B = 3,
     L = 16001 (the sinc frontend on a freq-masked bank there): the
     frontend, the CUDA-core kernel in both types and the tensor-core
     kernel's plain store in bf16; the padded frontend likewise, then block
     0 on its frame (the CUDA-core kernel in f32; in bf16 the older kernel
     and the warp-specialised one, with both kernels' phase times from
     their timer builds and the new one's timing cuts; the two bf16
     kernels must agree bit for bit, also on frames of two and three
     bands); kernel times in turns beside plain, cuDNN-chain and bound;
     then the tensor-core
     frontend in its two probe layouts (bfloat16 only, also at the probes'
     B = 256) and the frontend + block-0 head; then every variant of the
     block-0 kernel (construct sets, stages, cast ladder; bfloat16) and the
     tail kernels (three pools, SELU + layout change; both types, one size
     with ragged tiles); then the step-cost kernel in its six modes at
     B = 128, T = 7168 and at a ragged geometry, and the chained-dot kernel
     at the twelve dot shapes at a visible eps, each with a planted fault
     its gate must tell;
  4. the main paths, each with every kernel wrapper's launch count reset
     just before and read just after, and checked: Scorer.from_config(
     "configs/AASIST.conf") with the pretrained weights (bf16, the
     tensor-core frontend) serves 5 requests of 1-6 s, then 131 (one full
     and one ragged batch of 128), pipelined two batches deep; a Scorer
     with use_fused_stack=True serves the same requests with the new block
     0, then with the older one; f32 Scorers without kernels, with the
     CUDA-core frontend and with the CUDA-core pair.  bf16 scores are
     checked against the f32 ones without kernels; on the golden's input,
     f32 logits with each kernel path on and off, f32 against the reference
     golden, and bf16 against f32;
  5. Scorer throughput at batch 128 in bf16 over 640 requests, pipelined
     and a batch a call, and on padded rows a batch a call, with the stack
     on (new and older block 0),
     with the frontend kernel only, and with both off, the device forward
     alone, and torch.profiler breakdowns of one such batch by CUDA kernel
     with the frontend kernel and with the stack (printed, not gated; the
     whole tables go to chiprun_out/profile_bf16_b128.txt and
     profile_bf16_b128_stack.txt);
  6. the nine probes through their entry points
     (aasist_tpu_torch.tools.probe_frontend_variants, probe_fe_fix,
     probe_feb0_ablate, probe_b0_constructs, probe_b0_ablate, probe_b0_epi,
     probe_tail_constructs, probe_stepcost, probe_mxu_shapes), each with
     the kernels' launch counts reset just before it and read just after;
     a probe that did not launch each of its kernels fails;
  7. one JSON line describing every ported kernel, the card's line, and
     last the device JSON line.
"""

from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Tolerances.  f32: the JAX kernel's own gate (tests/test_fused_frontend.py).
# bf16 frontend: the plain chain rounds to bf16 after the conv, the BN and
# the SELU, the kernel once at the end.  Each rounding is at most 2^-8
# relative (one bf16 ulp is 0.125 at the outputs' top of ~20), so the two
# differ by an ulp or two: 2e-2 relative, plus 2e-2 absolute near zero.
# bf16 logits: the whole trunk in bf16 (8-bit mantissa, 7 convs) drifts by
# ~1e-2 on logits of magnitude ~2 (CPU measurement on the golden input);
# 0.1 leaves room for cuDNN's other summation orders.
# Block 0 is gated on max|kernel - plain| / max|plain|.  f32: the JAX
# pair's own gate (tools/test_fused_stack.py), 5e-5.  bf16: the plain chain
# rounds to bf16 after conv1, the BN, the SELU, conv2, the downsample and
# the add; the kernel rounds y1 once (conv2's tensor-core operand) and the
# output once.  Each rounding is at most 2^-9 relative; the y1 roundings
# enter conv2's 192-term sums as uncorrelated errors, so the two differ by
# an ulp or two of the largest outputs (one ulp there is 2^-8 to 2^-7 of
# max|plain|): 2e-2 of max|plain|.
# The tensor-core frontend (bf16 only) multiplies the same bf16 operands
# exactly and sums in f32 in another order, then rounds once: the bf16
# frontend gate holds for it, and for the head's x0.  The head's y1 is gated
# like block 0, on max|kernel - plain| / max|plain|.  f32: 5e-5, the JAX
# pair's gate; conv1 is six f32 FMAs on an x0 within 2e-6 of the plain one.
# bf16: the plain chain rounds after conv1, the BN and the SELU and reads
# bf16 conv1 weights, the kernel rounds once after f32 sums over folded f32
# taps, and their x0 differ by an ulp; three or four half-ulp errors at the
# largest outputs (one ulp is 2^-8 to 2^-7 of max|plain|).  A sound kernel
# reads 1.6e-2 to 1.9e-2 on the inputs here and in probe_feb0_ablate, and
# the same kernel with one conv1 tap zeroed reads 0.97 (that probe prints
# both, NVIDIA H100 80GB HBM3, 700.00 W): the gate is 4e-2, twice the
# one and a twentieth of the other.  It is wide for small outputs, so the
# bf16 y1 is also held element by element against conv1 + bn2 + SELU
# computed in f32 from the kernel's own x0, which differs from it by one
# rounding (tools/_common.py:HEAD_Y1_OWN_X0_TOL, with its reason; sound
# 0.5 of the tolerance, bf16 accumulation 32, the zeroed tap 4.7e3).
# The block-0 variants (bf16) are gated against plain versions that repeat
# the kernel's rounding sequence, by tools/_common.py:b0_readings, where the
# gates stand with their reasons and readings: the sets with the default's
# values at block 0's gate; the bf16 epilogues at one output ulp, nearer to
# their own plain version than to the f32 epilogue's, and telling a zeroed
# conv1 tap; stages dma .. epi at an ulp of the largest output and in the
# mean, telling a zeroed downsample bias or frame row.  The block-0 probes
# apply the same gates.
# The pools pick one of three stored values: exact.
# selu_to_nchw is SELU in f32 on both sides, rounded once: a bf16 ulp
# (rtol 2^-7) or 1e-6 in f32.
TOL_F32 = dict(atol=1e-4, rtol=0.0)
TOL_BF16_KERNEL = dict(atol=2e-2, rtol=2e-2)
TOL_BLOCK0 = {"float32": 5e-5, "bfloat16": 2e-2}
TOL_HEAD_Y1 = {"float32": 5e-5, "bfloat16": 4e-2}
TOL_SELU_NCHW = {"float32": dict(atol=1e-6, rtol=1e-6),
                 "bfloat16": dict(atol=1e-6, rtol=2.0 ** -7)}
TOL_MODEL_ON_OFF = dict(atol=2e-4, rtol=1e-4)
TOL_GOLDEN = dict(atol=2e-2, rtol=2e-2)
TOL_BF16_LOGITS = dict(atol=0.1, rtol=0.0)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def max_abs_diff(a, b) -> float:
    """max |a - b| in float32, a slice of the batch at a time (the head's
    y1 is 8.4 GB in float32)."""
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a.split(16), b.split(16)))


def profile_forward(model, x, card: str, label: str, fname: str) -> None:
    """Device time of one forward by kernel name, and the device's idle
    share of the window, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: the CPU ops' rows repeat their kernels' time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / fname, "w") as f:
        f.write(f"{card}\nwindow {wall_ms:.3f} ms, device busy {busy:.3f} "
                f"ms\n")
        for ms, n, key in rows:
            f.write(f"{ms:10.3f} ms  {n:5d}x  {key}\n")
    print(f"[profile] bf16 forward batch 128, {label}: window "
          f"{wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}  [{card}]")
    for ms, n, key in rows[:12]:
        print(f"[profile] {ms:9.3f} ms {n:4d}x  {key[:100]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not (ROOT / "aasist_tpu_torch").is_dir():
        fail(f"no aasist_tpu_torch package beside {__file__}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.data.dataset import pad_to_fixed
    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import block0_variants as bv
    from aasist_tpu_torch.ops import mma_shapes as mm
    from aasist_tpu_torch.ops import stepcost as sc
    from aasist_tpu_torch.ops import tail_constructs as tc
    from aasist_tpu_torch.ops.frontend_head import (
        fused_frontend_head, fused_frontend_head_reference)
    from aasist_tpu_torch.ops import block0_pipe as bp
    from aasist_tpu_torch.ops.frontend_variants import (
        fused_frontend_dot_bm, fused_frontend_dot_bm_reference,
        fused_frontend_dot_fm, fused_frontend_dot_fm_reference,
        fused_frontend_dot_padded, fused_frontend_dot_plain)
    from aasist_tpu_torch.ops.fused_frontend import (
        fused_frontend_fma, fused_frontend_reference)
    from aasist_tpu_torch.ops.fused_stack import (
        fused_block0_fma, fused_block0_mma, fused_block0_reference,
        fused_frontend_padded, fused_frontend_padded_fma,
        fused_frontend_padded_reference)
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.serving import Scorer
    from aasist_tpu_torch.tools import (
        probe_b0_ablate, probe_b0_constructs, probe_b0_epi, probe_fe_fix,
        probe_feb0_ablate, probe_frontend_variants, probe_mxu_shapes,
        probe_stepcost, probe_tail_constructs)
    from aasist_tpu_torch.tools._common import (
        B0_BF16_EPILOGUES, HEAD_Y1_OWN_X0_TOL, b0_fault, b0_readings,
        block0_bound, bytes_bound, card_line, cuda_ms, frontend_bound,
        head_bound, head_y1_excess, max_abs_err, stage_bound,
        stepcost_bound)
    from aasist_tpu_torch.weights import load_npz

    # ---------------------------------------------------------------- 1
    card = card_line()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    print(f"card (name, power limit): {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convolutions and matmuls (f32 checks are full "
          "f32)")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    construct_sets = probe_b0_constructs.SETS
    variants = {}                      # the builds of fused_block0.cu
    for d in ([bv.constructs_defines(*f) for f in construct_sets.values()]
              + [bv.stage_defines(st) for st in bv.STAGES]
              + [bv.epi_defines(v) for v in bv.EPI_VARIANTS]
              + [bv.cut_defines(c) for c in bv.CUTS]):
        variants[json.dumps(d, sort_keys=True)] = d
    variants[json.dumps(bp.TIMER_DEFINES)] = bp.TIMER_DEFINES
    entries = [(n, None) for n in ("fused_frontend", "frontend_dot",
                                   "frontend_head", "tail_constructs",
                                   "stepcost", "mma_shapes", "block0_pipe")]
    entries += [("block0_pipe", bp.TIMER_DEFINES)]
    entries += [("block0_pipe", {"B0P_CUT": c}) for c in bp.PIPE_CUTS.values()]
    entries += [("fused_block0", d) for d in variants.values()]
    libs = _build.load_all(entries)
    print(f"[build] {len(libs)} libraries in parallel ({len(variants)} of "
          f"fused_block0.cu, {2 + len(bp.PIPE_CUTS)} of block0_pipe.cu): "
          f"{time.perf_counter() - t0:.1f} s")
    for (_, defines), lib in zip(entries, libs):
        print(f"[build] {lib.path.name} {defines or ''}: nvcc "
              f"{lib.build_seconds:.1f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    # ---------------------------------------------------------------- 3
    cfg = load_config(ROOT / "configs" / "AASIST.conf")
    weights = ROOT / cfg.model_path
    model32 = load_npz(build_model(cfg.model_config), weights)
    bn = model32.first_bn

    def bn_dicts(dtype):
        conv = lambda t: t.detach().to("cuda", dtype)
        return ({"weight": conv(bn.weight), "bias": conv(bn.bias)},
                {"mean": conv(bn.running_mean), "var": conv(bn.running_var)})

    def library_chain(x, bank, bn_p, bn_s):
        # the same function from stock PyTorch / cuDNN calls
        h = F.conv1d(x[:, None], bank[:, None]).abs()
        h = F.max_pool2d(h[:, None], 3)
        h = F.batch_norm(h, bn_s["mean"], bn_s["var"], bn_p["weight"],
                         bn_p["bias"], training=False, eps=1e-5)
        return F.selu(h)

    gen = torch.Generator(device="cuda").manual_seed(0)
    # the CUDA-core frontend (both types) and, in bf16, the tensor-core
    # frontend's plain store, each against the plain version
    results = {}                       # fused_frontend_fma
    dot_plain_results = {}             # fused_frontend_dot_plain
    cases = [("float32", 128, 64600, False), ("bfloat16", 128, 64600, False),
             ("float32", 3, 16001, True), ("bfloat16", 3, 16001, True)]
    for dname, b, length, masked in cases:
        dtype = getattr(torch, dname)
        x = (torch.randn((b, length), generator=gen, device="cuda")
             * 0.1).to(dtype)
        bank = model32.filterbank.detach().to("cuda", dtype).clone()
        if masked:
            bank[10:20] = 0
        bn_p, bn_s = bn_dicts(dtype)
        ref = fused_frontend_reference(x, bank, bn_p, bn_s)
        shape = (b, 1, 23, (length - 128) // 3)
        tol = TOL_F32 if dname == "float32" else TOL_BF16_KERNEL
        tag = f"{dname} B={b} L={length}{' masked' if masked else ''}"
        kernels_here = [("fused_frontend_fma", fused_frontend_fma, results)]
        if dname == "bfloat16":
            kernels_here.append(("fused_frontend_dot_plain",
                                 fused_frontend_dot_plain, dot_plain_results))
        outs = {}
        for kname, fn, store in kernels_here:
            got = fn(x, bank, bn_p, bn_s)
            torch.cuda.synchronize()
            check(tuple(got.shape) == shape and got.dtype == dtype,
                  f"{kname} output {tuple(got.shape)} {got.dtype}, want "
                  f"{shape}")
            check(bool(torch.isfinite(got).all()), f"{kname} not finite")
            err = (got.float() - ref.float()).abs().max().item()
            print(f"[kernel] {kname} {tag}: max|kernel-plain| = {err:.3e}"
                  f" (atol {tol['atol']}, rtol {tol['rtol']})")
            check(torch.allclose(got.float(), ref.float(), **tol),
                  f"{kname} disagrees with its plain version, {tag}")
            outs[kname] = got
            if b == 128:
                store[dname] = dict(max_abs_err=err)
        if len(outs) == 2:
            d = (outs["fused_frontend_fma"].float()
                 - outs["fused_frontend_dot_plain"].float()).abs().max()
            print(f"[kernel] {tag}: max|tensor-core - CUDA-core frontend| "
                  f"= {d.item():.3e} (not gated)")
        del outs, got
        if b == 128:
            plain = cuda_ms(
                lambda: fused_frontend_reference(x, bank, bn_p, bn_s), 10)
            libms = cuda_ms(lambda: library_chain(x, bank, bn_p, bn_s), 10)
            bound, by = frontend_bound(b, length, 70, dname)
            # in turns: each kernel timed twice, the second time in reverse
            # order
            runs = {k: [] for k, _, _ in kernels_here}
            for kname, fn, _ in kernels_here + kernels_here[::-1]:
                runs[kname].append(
                    cuda_ms(lambda: fn(x, bank, bn_p, bn_s), 20))
            for kname, fn, store in kernels_here:
                ms = float(np.mean(runs[kname]))
                store[dname].update(ms=ms, plain_ms=plain, library_ms=libms,
                                    bound_ms=bound, bound_by=by)
                print(f"[kernel] {kname} {tag}: kernel {ms:.4f} ms (runs "
                      f"{[round(v, 4) for v in runs[kname]]}), plain "
                      f"{plain:.4f} ms, cuDNN chain {libms:.4f} ms, bound "
                      f"{bound:.4f} ms ({by})  [{card}]")
        del x, ref
    torch.cuda.empty_cache()

    # the frontend + block-0 pair; block 0's plain version is its cuDNN
    # chain (conv1, BN, SELU, conv2, downsample, add, max_pool2d).  The
    # padded frontend: the CUDA-core kernel in both types, the tensor-core
    # one in bf16; block 0: the CUDA-core kernel in f32, in bf16 the older
    # kernel and the warp-specialised one, on the bf16 frame of the
    # tensor-core frontend.  Times in turns (old, new, new, old).
    stack_results = {"float32": {}, "bfloat16": {}}
    phases = {}
    for dname, b, length in [("float32", 128, 64600),
                             ("bfloat16", 128, 64600),
                             ("float32", 3, 16001), ("bfloat16", 3, 16001)]:
        dtype = getattr(torch, dname)
        bf16 = dname == "bfloat16"
        tag = f"{dname} B={b} L={length}"
        x = (torch.randn((b, length), generator=gen, device="cuda")
             * 0.1).to(dtype)
        bank = model32.filterbank.detach().to("cuda", dtype)
        bn_p, bn_s = bn_dicts(dtype)
        block = copy.deepcopy(model32.encoder[0]).to("cuda", dtype)
        res = stack_results[dname] if b == 128 else {}
        with torch.inference_mode():
            zr = fused_frontend_padded_reference(x, bank, bn_p, bn_s)
            shape = (b, 25, (length - 128) // 3 + 2)
            tol = TOL_F32 if dname == "float32" else TOL_BF16_KERNEL
            fe_kernels = [("fused_frontend_padded", fused_frontend_padded_fma)]
            if bf16:
                fe_kernels.append(("fused_frontend_dot_padded",
                                   fused_frontend_dot_padded))
            frames = {}
            for kname, fn in fe_kernels:
                z = fn(x, bank, bn_p, bn_s)
                torch.cuda.synchronize()
                check(tuple(z.shape) == shape and z.dtype == dtype,
                      f"{kname} output {tuple(z.shape)} {z.dtype}, want "
                      f"{shape}")
                border = (torch.cat([z[:, 0], z[:, -1]], 1).abs().max()
                          .item() + torch.cat([z[:, :, 0], z[:, :, -1]], 1)
                          .abs().max().item())
                check(border == 0, f"{kname} border not zero, {tag}")
                err_z = (z.float() - zr.float()).abs().max().item()
                print(f"[kernel] {kname} {tag}: max|kernel-plain| = "
                      f"{err_z:.3e} (atol {tol['atol']}, rtol "
                      f"{tol['rtol']}), border exactly 0")
                check(torch.allclose(z.float(), zr.float(), **tol),
                      f"{kname} disagrees with its plain version, {tag}")
                frames[kname] = z
                res[kname] = dict(max_abs_err=err_z)
            del zr
            z = frames[fe_kernels[-1][0]]     # the frame the Scorer reads
            del frames

            ref = fused_block0_reference(z, block)
            top = ref.float().abs().max().item()
            shape = (b, 32, 23, (length - 128) // 9)
            b0_kernels = ([("fused_block0", fused_block0_mma),
                           ("block0_pipe", bp.block0_pipe)] if bf16
                          else [("fused_block0", fused_block0_fma)])
            outs = {}
            for kname, fn in b0_kernels:
                out = fn(z, block)
                torch.cuda.synchronize()
                check(tuple(out.shape) == shape and out.dtype == dtype,
                      f"{kname} output {tuple(out.shape)} {out.dtype}, want "
                      f"{shape}")
                check(bool(torch.isfinite(out).all()),
                      f"{kname} output not finite")
                err_b = (out.float() - ref.float()).abs().max().item()
                print(f"[kernel] {kname} {tag}: max|kernel-plain| = "
                      f"{err_b:.3e}, / max|plain| = {err_b / top:.3e} (gate "
                      f"{TOL_BLOCK0[dname]})")
                check(err_b / top <= TOL_BLOCK0[dname],
                      f"{kname} disagrees with its plain version, {tag}")
                outs[kname] = out
                res[kname] = dict(max_abs_err=err_b, max_rel_err=err_b / top)
            del ref
            if bf16:
                same = (outs["fused_block0"].float()
                        - outs["block0_pipe"].float()).abs().max().item()
                print(f"[kernel] {tag}: max|block0_pipe - fused_block0| = "
                      f"{same:.3e} (the same function, gate 0)")
                check(same == 0, f"the two bf16 block-0 kernels differ, "
                      f"{tag}")
                timed, phases_new = bp.block0_timed(z, block, "pipe")
                torch.cuda.synchronize()
                check(torch.equal(timed, outs["block0_pipe"]),
                      f"block0_pipe's timer build changed its output, {tag}")
                timed, phases_old = bp.block0_timed(z, block, "mma")
                torch.cuda.synchronize()
                check(torch.equal(timed, outs["fused_block0"]),
                      f"fused_block0's timer build changed its output, {tag}")
                del timed
                if b == 128:
                    phases = {"block0_pipe": phases_new,
                              "fused_block0": phases_old}
                for kname, ph in (("block0_pipe", phases_new),
                                  ("fused_block0", phases_old)):
                    print(f"[phases] {kname} {tag}: one launch, per CTA: "
                          f"life {ph['cta']:.4f} ms, clock "
                          f"{ph['clock_ghz']:.3f} GHz  [{card}]")
                    for name, ms in ph.items():
                        if name not in ("cta", "clock_ghz"):
                            print(f"[phases]   {ms:8.4f} ms  {name}")
            del outs
            if b == 128:
                plain_z = cuda_ms(lambda: fused_frontend_padded_reference(
                    x, bank, bn_p, bn_s), 10)
                lib_z = cuda_ms(lambda: F.pad(library_chain(
                    x, bank, bn_p, bn_s)[:, 0], (1, 1, 1, 1)), 10)
                bound_z, by_z = frontend_bound(b, length, 70, dname,
                                               padded=True)
                runs = {k: [] for k, _ in fe_kernels}
                for kname, fn in fe_kernels + fe_kernels[::-1]:
                    runs[kname].append(
                        cuda_ms(lambda: fn(x, bank, bn_p, bn_s), 20))
                for kname, _ in fe_kernels:
                    ms = float(np.mean(runs[kname]))
                    res[kname].update(ms=ms, plain_ms=plain_z,
                                      library_ms=lib_z, bound_ms=bound_z,
                                      bound_by=by_z)
                    print(f"[kernel] {kname} {tag}: kernel {ms:.4f} ms (runs "
                          f"{[round(v, 4) for v in runs[kname]]}), plain "
                          f"{plain_z:.4f} ms, cuDNN chain {lib_z:.4f} ms, "
                          f"bound {bound_z:.4f} ms ({by_z})  [{card}]")
                plain_b = cuda_ms(lambda: fused_block0_reference(z, block), 5)
                bound_b, by_b = block0_bound(b, length, 32, dname)
                runs = {k: [] for k, _ in b0_kernels}
                for kname, fn in b0_kernels + b0_kernels[::-1]:
                    runs[kname].append(cuda_ms(lambda: fn(z, block), 10))
                for kname, _ in b0_kernels:
                    ms = float(np.mean(runs[kname]))
                    res[kname].update(ms=ms, plain_ms=plain_b,
                                      library_ms=plain_b, bound_ms=bound_b,
                                      bound_by=by_b)
                    print(f"[kernel] {kname} {tag}: kernel {ms:.4f} ms (runs "
                          f"{[round(v, 4) for v in runs[kname]]}), plain (= "
                          f"the cuDNN chain) {plain_b:.4f} ms, bound "
                          f"{bound_b:.4f} ms ({by_b})  [{card}]")
                if bf16:
                    cuts = {}
                    for cut in bp.PIPE_CUTS:
                        cuts[cut] = cuda_ms(
                            lambda: bp.block0_pipe_cut(z, block, cut), 10)
                    res["block0_pipe"]["cuts_ms"] = cuts
                    print(f"[kernel] block0_pipe {tag}: timing cuts "
                          f"{ {k: round(v, 4) for k, v in cuts.items()} } "
                          f"(ms; the skeleton's bound is "
                          f"{stage_bound('dma', b, length, 32, dname)[0]:.4f}"
                          f" ms, bytes)  [{card}]")
        del x, z, block
        torch.cuda.empty_cache()

    # block 0 in bands: frames of F = 30 and 47 rows (two and three bands
    # of block0_pipe's 23 rows; the model's F is 23), seeded noise inside a
    # zero border, both bf16 kernels against the plain version
    block = copy.deepcopy(model32.encoder[0]).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        for b, f, t in [(2, 30, 300), (3, 47, 1001)]:
            z = torch.zeros((b, f + 2, t + 2), device="cuda",
                            dtype=torch.bfloat16)
            z[:, 1:-1, 1:-1] = torch.randn((b, f, t), generator=gen,
                                           device="cuda").bfloat16()
            ref = fused_block0_reference(z, block)
            top = ref.float().abs().max().item()
            outs = {}
            for kname, fn in (("fused_block0", fused_block0_mma),
                              ("block0_pipe", bp.block0_pipe)):
                out = fn(z, block)
                torch.cuda.synchronize()
                rel = (out.float() - ref.float()).abs().max().item() / top
                print(f"[kernel] {kname} bfloat16 frame F={f} T_z={t} "
                      f"B={b}: max|kernel-plain| / max|plain| = {rel:.3e} "
                      f"(gate {TOL_BLOCK0['bfloat16']})")
                check(tuple(out.shape) == (b, 32, f, t // 3)
                      and rel <= TOL_BLOCK0["bfloat16"],
                      f"{kname} disagrees with its plain version, F={f}")
                outs[kname] = out
            check(torch.equal(outs["fused_block0"], outs["block0_pipe"]),
                  f"the two bf16 block-0 kernels differ at F={f}")
    del block, z, ref, outs

    # the frontend on the tensor cores, in its two store layouts (bf16 only)
    dots = {"fused_frontend_dot_fm": (fused_frontend_dot_fm,
                                      fused_frontend_dot_fm_reference, 0),
            "fused_frontend_dot_bm": (fused_frontend_dot_bm,
                                      fused_frontend_dot_bm_reference, 1)}
    dot_results = {}
    for b, length, masked in [(128, 64600, False), (256, 64600, False),
                              (3, 16001, True)]:
        tag = f"bfloat16 B={b} L={length}{' masked' if masked else ''}"
        x = (torch.randn((b, length), generator=gen, device="cuda")
             * 0.1).bfloat16()
        bank = model32.filterbank.detach().to("cuda", torch.bfloat16).clone()
        if masked:
            bank[10:20] = 0
        bn_p, bn_s = bn_dicts(torch.bfloat16)
        t_out = (length - 128) // 3
        v1 = fused_frontend_fma(x, bank, bn_p, bn_s)[:, 0]
        for name, (fn, ref_fn, row_axis) in dots.items():
            got = fn(x, bank, bn_p, bn_s)
            torch.cuda.synchronize()
            ref = ref_fn(x, bank, bn_p, bn_s)
            shape = (24, b, t_out) if row_axis == 0 else (b, 24, t_out)
            check(tuple(got.shape) == shape and got.dtype == torch.bfloat16
                  and got.is_contiguous(),
                  f"{name} output {tuple(got.shape)} {got.dtype}, want "
                  f"{shape}")
            check(bool(torch.isfinite(got).all()), f"{name} not finite")
            rows = got.movedim(row_axis, 0)                  # (24, B, T)
            row_max = rows.abs().amax(dim=(1, 2)).float()
            check(row_max[23].item() == 0 and bool((row_max[:23] > 0).all()),
                  f"{name}: row 23 and nothing else must be zero, {tag}")
            err = (got.float() - ref.float()).abs().max().item()
            d_v1 = (rows[:23].movedim(0, 1).float()
                    - v1.float()).abs().max().item()
            print(f"[kernel] {name} {tag}: max|kernel-plain| = {err:.3e} "
                  f"(atol {TOL_BF16_KERNEL['atol']}, rtol "
                  f"{TOL_BF16_KERNEL['rtol']}), row 23 exactly 0; "
                  f"max|kernel - fused_frontend_fma| = {d_v1:.3e} (not "
                  "gated)")
            check(torch.allclose(got.float(), ref.float(), **TOL_BF16_KERNEL),
                  f"{name} disagrees with its plain version, {tag}")
            if b == 128:
                ms = cuda_ms(lambda: fn(x, bank, bn_p, bn_s), 20)
                plain = cuda_ms(lambda: ref_fn(x, bank, bn_p, bn_s), 10)

                def lib_fn():
                    h = F.pad(library_chain(x, bank, bn_p, bn_s)[:, 0],
                              (0, 0, 0, 1))
                    return (h.permute(1, 0, 2).contiguous() if row_axis == 0
                            else h)
                libms = cuda_ms(lib_fn, 10)
                bound, by = frontend_bound(b, length, 70, "bfloat16", rows=24)
                dot_results[name] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, library_ms=libms,
                    bound_ms=bound, bound_by=by)
                print(f"[kernel] {name} {tag}: kernel {ms:.4f} ms, plain "
                      f"{plain:.4f} ms, cuDNN chain {libms:.4f} ms, bound "
                      f"{bound:.4f} ms ({by})  [{card}]")
            del got, ref, rows
        del x, v1
    torch.cuda.empty_cache()

    # the frontend + block-0 head: x0 gated like the frontend, y1 like
    # block 0
    def head_library_chain(x, bank, bn_p, bn_s, block):
        h = library_chain(x, bank, bn_p, bn_s)
        y = F.conv2d(h, block.conv1.weight, block.conv1.bias, padding=(1, 1))
        y = F.batch_norm(y, block.bn2.running_mean, block.bn2.running_var,
                         block.bn2.weight, block.bn2.bias, training=False,
                         eps=1e-5)
        return F.selu(y), F.pad(h[:, 0], (0, 0, 0, 1))

    head_results = {}
    for dname, b, length, masked in cases:
        dtype = getattr(torch, dname)
        tag = f"{dname} B={b} L={length}{' masked' if masked else ''}"
        x = (torch.randn((b, length), generator=gen, device="cuda")
             * 0.1).to(dtype)
        bank = model32.filterbank.detach().to("cuda", dtype).clone()
        if masked:
            bank[10:20] = 0
        bn_p, bn_s = bn_dicts(dtype)
        block = copy.deepcopy(model32.encoder[0]).to("cuda", dtype)
        t_out = (length - 128) // 3
        with torch.inference_mode():
            y1, x0 = fused_frontend_head(x, bank, bn_p, bn_s, block)
            torch.cuda.synchronize()
            ry1, rx0 = fused_frontend_head_reference(x, bank, bn_p, bn_s,
                                                     block)
            check(tuple(y1.shape) == (b, 32, 24, t_out)
                  and tuple(x0.shape) == (b, 24, t_out)
                  and y1.dtype == x0.dtype == dtype,
                  f"head outputs {tuple(y1.shape)} {tuple(x0.shape)} "
                  f"{y1.dtype}")
            check(bool(torch.isfinite(y1).all())
                  and bool(torch.isfinite(x0).all()), "head not finite")
            row_max = x0.abs().amax(dim=(0, 2)).float()
            check(row_max[23].item() == 0 and bool((row_max[:23] > 0).all()),
                  f"head x0: row 23 and nothing else must be zero, {tag}")
            tol = TOL_F32 if dname == "float32" else TOL_BF16_KERNEL
            err_x0 = max_abs_diff(x0, rx0)
            err_y1 = max_abs_diff(y1, ry1)
            rel_y1 = err_y1 / ry1.abs().max().float().item()
            print(f"[kernel] fused_frontend_head {tag}: x0 max|kernel-plain|"
                  f" = {err_x0:.3e} (atol {tol['atol']}, rtol {tol['rtol']}),"
                  f" row 23 exactly 0; y1 max|kernel-plain| = {err_y1:.3e}, "
                  f"/ max|plain| = {rel_y1:.3e} (gate {TOL_HEAD_Y1[dname]})")
            check(torch.allclose(x0.float(), rx0.float(), **tol),
                  f"the head's x0 disagrees with its plain version, {tag}")
            check(rel_y1 <= TOL_HEAD_Y1[dname],
                  f"the head's y1 disagrees with its plain version, {tag}")
            if dname == "bfloat16":
                excess = head_y1_excess(y1, x0, block, **HEAD_Y1_OWN_X0_TOL)
                print(f"[kernel] fused_frontend_head {tag}: y1 against the "
                      f"f32 head of its own x0, worst element over (atol "
                      f"{HEAD_Y1_OWN_X0_TOL['atol']}, rtol "
                      f"{HEAD_Y1_OWN_X0_TOL['rtol']:.3e}) = {excess:.3e} "
                      f"(gate 1)")
                check(excess <= 1, f"the head's y1 is not conv1 + bn2 + "
                      f"SELU of its x0 element by element, {tag}")
            del y1, x0, ry1, rx0
            if b == 128:
                ms = cuda_ms(lambda: fused_frontend_head(
                    x, bank, bn_p, bn_s, block), 10)
                plain = cuda_ms(lambda: fused_frontend_head_reference(
                    x, bank, bn_p, bn_s, block), 5)
                libms = cuda_ms(lambda: head_library_chain(
                    x, bank, bn_p, bn_s, block), 5)
                bound, by = head_bound(b, length, 70, dname)
                head_results[dname] = dict(
                    max_abs_err=err_y1, max_rel_err=rel_y1,
                    x0_max_abs_err=err_x0, ms=ms, plain_ms=plain,
                    library_ms=libms, bound_ms=bound, bound_by=by)
                print(f"[kernel] fused_frontend_head {tag}: kernel {ms:.4f} "
                      f"ms, plain {plain:.4f} ms, cuDNN chain {libms:.4f} "
                      f"ms, bound {bound:.4f} ms ({by})  [{card}]")
        del x, block
        torch.cuda.empty_cache()

    # the block-0 variants (bf16 only): every construct set, stage and
    # cast-ladder variant against its plain version
    families = {
        "fused_block0_constructs": (
            bv.fused_block0_constructs,
            bv.fused_block0_constructs_reference, construct_sets),
        "fused_block0_stage": (
            bv.fused_block0_stage, bv.fused_block0_stage_reference,
            {st: (st,) for st in bv.STAGES}),
        "fused_block0_epi": (
            bv.fused_block0_epi, bv.fused_block0_epi_reference,
            {v: (v,) for v in bv.EPI_VARIANTS})}
    variant_results = {name: {} for name in families}
    for b, length in [(128, 64600), (3, 16001)]:
        tag = f"bfloat16 B={b} L={length}"
        x = (torch.randn((b, length), generator=gen, device="cuda")
             * 0.1).bfloat16()
        bank = model32.filterbank.detach().to("cuda", torch.bfloat16)
        bn_p, bn_s = bn_dicts(torch.bfloat16)
        block = copy.deepcopy(model32.encoder[0]).to("cuda", torch.bfloat16)
        with torch.inference_mode():
            z = fused_frontend_padded(x, bank, bn_p, bn_s)
            shape = (b, 32, 23, (length - 128) // 9)
            plain_base = bv.fused_block0_epi_reference(z, block, "base")
            for fam, (fn, ref_fn, cases_) in families.items():
                for vname, vargs in cases_.items():
                    got = fn(z, block, *vargs)
                    torch.cuda.synchronize()
                    plain = ref_fn(z, block, *vargs)
                    check(tuple(got.shape) == shape
                          and got.dtype == torch.bfloat16
                          and bool(torch.isfinite(got).all()),
                          f"{fam} {vname}: output {tuple(got.shape)} "
                          f"{got.dtype}, or not finite")
                    err = (got.float() - plain.float()).abs().max().item()
                    fault = b0_fault(vname, z, block)
                    bad = fault and fn(*fault, *vargs)
                    text, fails = b0_readings(
                        vname, got, plain, bad,
                        plain_base if vname in B0_BF16_EPILOGUES else None)
                    print(f"[kernel] {fam} {vname} {tag}: max|kernel-plain| "
                          f"= {err:.3e}, {text}")
                    check(not fails, f"{fam}, {tag}: " + "; ".join(fails))
                    del got, bad, fault
                    if b == 128:
                        ms = cuda_ms(lambda: fn(z, block, *vargs), 5)
                        plain_ms = cuda_ms(lambda: ref_fn(z, block, *vargs),
                                           1, warmup=0)
                        bound, by = (
                            stage_bound(vname, b, length, 32, "bfloat16")
                            if fam == "fused_block0_stage"
                            else block0_bound(b, length, 32, "bfloat16"))
                        top = plain.float().abs().max().item()
                        variant_results[fam][vname] = dict(
                            max_abs_err=err, max_rel_err=err / top, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                            library_ms=None)
                        print(f"[kernel] {fam} {vname} {tag}: kernel "
                              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                              f"{bound:.4f} ms ({by})  [{card}]")
                    del plain
            del plain_base
        del x, z, block
        torch.cuda.empty_cache()

    # the tail kernels: the pools are exact, SELU + layout within an ulp
    tail_results = {}
    for dname, b, t in [("bfloat16", 64, 4608), ("float32", 64, 4608),
                        ("bfloat16", 3, 5291), ("float32", 3, 5291),
                        ("bfloat16", 128, 21489)]:
        dtype = getattr(torch, dname)
        tag = f"{dname} B={b} T={t}"
        rand = lambda *sh: (torch.randn(sh, generator=gen, device="cuda")
                            * 0.5).to(dtype)
        timed = b != 3
        n_in, n_out = b * 32 * 23 * 3 * (t // 3), b * 32 * 23 * (t // 3)
        y = rand(b, 32, 23, t)
        plain = tc.pool3_time_reference(y)
        pool_cases = [(f"pool3_time {how}", how) for how in tc.POOL_HOW]
        for label, how in pool_cases:
            got = tc.pool3_time(y, how)
            torch.cuda.synchronize()
            check(got.shape == plain.shape and got.dtype == dtype,
                  f"{label}: output {tuple(got.shape)} {got.dtype}")
            err = (got.float() - plain.float()).abs().max().item()
            print(f"[kernel] {label} {tag}: max|kernel-plain| = {err:.1e} "
                  f"(gate 0)")
            check(err == 0, f"{label} is not exact, {tag}")
            if timed:
                ms = cuda_ms(lambda: tc.pool3_time(y, how), 10)
                lib_ms = cuda_ms(lambda: F.max_pool2d(y, (1, 3)), 10)
                bound, by = bytes_bound(n_in, n_out, dname)
                tail_results[(label, dname, b)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=lib_ms, bound_ms=bound,
                    bound_by=by, library_ms=lib_ms)
                print(f"[kernel] {label} {tag}: kernel {ms:.4f} ms, plain (= "
                      f"F.max_pool2d) {lib_ms:.4f} ms, bound {bound:.4f} ms "
                      f"({by})  [{card}]")
        del y, plain, got
        y = rand(b, 32, t, 23)
        got = tc.pool3_time_major(y)
        torch.cuda.synchronize()
        plain = tc.pool3_time_major_reference(y)
        check(got.shape == plain.shape and got.dtype == dtype,
              f"pool3_time_major: output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - plain.float()).abs().max().item()
        print(f"[kernel] pool3_time_major {tag}: max|kernel-plain| = "
              f"{err:.1e} (gate 0)")
        check(err == 0, f"pool3_time_major is not exact, {tag}")
        if timed:
            ms = cuda_ms(lambda: tc.pool3_time_major(y), 10)
            plain_ms = cuda_ms(lambda: tc.pool3_time_major_reference(y), 5)
            lib_ms = cuda_ms(lambda: F.max_pool2d(y, (3, 1)), 10)
            bound, by = bytes_bound(n_in, n_out, dname)
            tail_results[("pool3_time_major", dname, b)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)
            print(f"[kernel] pool3_time_major {tag}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, F.max_pool2d (3,1) {lib_ms:.4f}"
                  f" ms, bound {bound:.4f} ms ({by})  [{card}]")
        del y, plain, got
        zc = rand(32, 24, b, t)
        plain = tc.selu_to_nchw_reference(zc)
        tol = TOL_SELU_NCHW[dname]
        hows = [None] + ([] if t % (16 // zc.element_size()) else ["staged"])
        for how in hows:          # None: "vector" where T allows it
            label = "selu_to_nchw" + (f" {how}" if how else "")
            got = tc.selu_to_nchw(zc, how)
            torch.cuda.synchronize()
            check(tuple(got.shape) == (b, 32, 24, t) and got.dtype == dtype
                  and got.is_contiguous(),
                  f"{label}: output {tuple(got.shape)} {got.dtype}")
            err = max_abs_diff(got, plain)
            print(f"[kernel] {label} {tag}: max|kernel-plain| = {err:.3e} "
                  f"(atol {tol['atol']}, rtol {tol['rtol']:.3e})")
            check(all(torch.allclose(g.float(), r.float(), **tol)
                      for g, r in zip(got.split(16), plain.split(16))),
                  f"{label} disagrees with its plain version, {tag}")
            del got
            if timed:
                ms = cuda_ms(lambda: tc.selu_to_nchw(zc, how), 10)
                plain_ms = cuda_ms(lambda: tc.selu_to_nchw_reference(zc), 5)
                bound, by = bytes_bound(zc.numel(), zc.numel(), dname)
                tail_results[(label, dname, b)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None)
                print(f"[kernel] {label} {tag}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by})  "
                      f"[{card}]")
        del plain
        del zc
        torch.cuda.empty_cache()

    # the step-cost kernel: every mode at block 0's grid geometry and at a
    # ragged one (g = 3, u = 104: a full 64-time sub-tile, then a 40-time
    # tail in which warps 5-7 hold no times), the output filled with NaN
    # first; gates and planted faults in tools/_common.py:stepcost_readings
    step_results = {}
    for b, t, g, u in [(probe_stepcost.BATCH, probe_stepcost.T_TOTAL, 8, 256),
                       (6, 312, 3, 104)]:
        tag = f"B={b} T={t} (g, u) = ({g}, {u})"
        x, w = probe_stepcost.inputs(b, t, seed=1)
        full = b == probe_stepcost.BATCH
        lib_fns = probe_stepcost.library_calls(x, w) if full else {}
        with torch.inference_mode():
            for mode in sc.MODES:
                plain = sc.stepcost_reference(mode, x, w, g, u)
                text, fails, err = probe_stepcost.check(mode, x, w, g, u,
                                                        True, plain)
                print(f"[kernel] stepcost {mode} {tag}: {text}")
                check(not fails, f"stepcost, {tag}: " + "; ".join(fails))
                if not full:
                    continue
                ms = cuda_ms(lambda: sc.stepcost(mode, x, w, g, u), 10)
                plain_ms = cuda_ms(
                    lambda: sc.stepcost_reference(mode, x, w, g, u), 3)
                lib_ms = cuda_ms(lib_fns[mode], 10)
                bound, by = stepcost_bound(mode, b, t)
                step_results[mode] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound, bound_by=by,
                    g=g, u=u)
                print(f"[kernel] stepcost {mode} {tag}: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, stock call {lib_ms:.4f} ms, "
                      f"bound {bound:.4f} ms ({by})  [{card}]")
                if mode == "matmul":
                    conv = lib_fns[mode]().permute(1, 0, 2, 3)
                    rel = (max_abs_err(conv, plain)
                           / plain.abs().max().item())
                    print(f"[kernel] stepcost matmul {tag}: the stock conv "
                          f"against the plain version, max|d| / max|plain| "
                          f"= {rel:.3e} (not gated: its summed taps are "
                          "rounded)")
                    del conv
                del plain
        del x, w, lib_fns
        torch.cuda.empty_cache()

    # the chained-dot kernel at every dot shape: checked at a visible eps
    # (tools/_common.py:mma_readings), timed a dot at the probe's eps
    mma_results = {}
    with torch.inference_mode():
        for name in mm.SHAPES:
            text, fails, err = probe_mxu_shapes.check(name)
            print(f"[kernel] mma_chain {name}: {text}")
            check(not fails, "mma_chain: " + "; ".join(fails))
            r = probe_mxu_shapes.measure(name, probe_mxu_shapes.N_DOTS, 5)
            mma_results[name] = dict(max_abs_err=err, **r)
            print(f"[kernel] mma_chain {name}: {1e3 * r['ms']:.3f} us a dot "
                  f"({r['tflops']:.1f} TF/s useful, {r['tflops_padded']:.1f}"
                  f" padded), plain {1e3 * r['plain_ms']:.3f} us, torch.mm "
                  f"{1e3 * r['library_ms']:.3f} us, bound "
                  f"{1e3 * r['bound_ms']:.3f} us ({r['bound_by']})  [{card}]")

    # ---------------------------------------------------------------- 4
    # every kernel wrapper a Scorer path can reach (the routers in front of
    # them count nothing); all counts are set to 0 just before each run and
    # read just after it
    path_kernels = {
        "fused_frontend_dot_plain": fused_frontend_dot_plain,
        "fused_frontend_dot_padded": fused_frontend_dot_padded,
        "block0_pipe": bp.block0_pipe,
        "fused_frontend_fma": fused_frontend_fma,
        "fused_frontend_padded_fma": fused_frontend_padded_fma,
        "fused_block0_mma": fused_block0_mma,
        "fused_block0_fma": fused_block0_fma}

    def older_block0(model, on):
        """Run ``model``'s stack path with the older bf16 block-0 kernel
        in place of block0_pipe (``on``), or as it is: an attribute of this
        model instance over ``AASIST.fused_stack``, so that these runs can
        tell what the new kernel saves from what its channels-last output
        saves blocks 1-5."""
        if not on:
            model.__dict__.pop("fused_stack", None)
            return
        bn = model.first_bn

        def fused_stack(x):
            z = fused_frontend_padded(
                x, model.filterbank, {"weight": bn.weight, "bias": bn.bias},
                {"mean": bn.running_mean, "var": bn.running_var})
            return fused_block0_mma(z, model.encoder[0])

        model.fused_stack = fused_stack

    def serve(scorer_, reqs, want, label):
        """Score ``reqs`` through ``scorer_``'s pipelined path and check the
        launch counts: ``want`` maps each kernel that must run to its count,
        and every other kernel wrapper must not run."""
        torch.cuda.synchronize()
        for fn in path_kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = [scorer_.score_waveforms(r) for r in reqs]
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in path_kernels.items()}
        print(f"[main] {label}: served {[len(s) for s in out]} requests in "
              f"{n_batches} batches, {wall:.3f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        for r, s in zip(reqs, out):
            check(len(s) == len(r), f"{len(s)} scores for {len(r)} requests")
            check(bool(np.isfinite(s).all()), f"{label}: non-finite scores")
        for name, n in counts.items():
            check(n == want.get(name, 0),
                  f"{label}: {name} launched {n} times, want "
                  f"{want.get(name, 0)} ({n_batches} batches)")
        return out, counts

    scorer = Scorer.from_config(ROOT / "configs" / "AASIST.conf",
                                weights_path=weights)
    check(scorer.device.type == "cuda" and scorer.model.use_fused_frontend,
          "the default Scorer must run on CUDA with the fused frontend")
    check(scorer.batch_size == 128, f"batch size {scorer.batch_size}")
    scorer.warmup()
    rng = np.random.default_rng(0)
    requests = [[(rng.standard_normal(n) * 0.1).astype(np.float32)
                 for n in rng.integers(16000, 96001, size)]
                for size in (5, 131)]
    n_batches = sum(-(-len(r) // scorer.batch_size) for r in requests)

    scores, launches = serve(scorer, requests, {
        "fused_frontend_dot_plain": n_batches}, "bf16 default path")

    # the frontend + block-0 pair's path, the same requests: with the
    # warp-specialised block 0, then with the older kernel
    stack = Scorer.from_config(ROOT / "configs" / "AASIST.conf",
                               weights_path=weights, use_fused_stack=True)
    check(stack.model.use_fused_stack, "Scorer(use_fused_stack=True)")
    stack.warmup()
    stack_want = {"fused_frontend_dot_padded": n_batches}
    stack_scores, stack_launches = serve(
        stack, requests, {**stack_want, "block0_pipe": n_batches},
        "bf16 stack path")
    older_block0(stack.model, True)
    old_scores, old_launches = serve(
        stack, requests, {**stack_want, "fused_block0_mma": n_batches},
        "bf16 stack path, the older block-0 kernel")
    older_block0(stack.model, False)
    d_old = max(np.abs(np.asarray(a) - np.asarray(b)).max()
                for a, b in zip(stack_scores, old_scores))
    print(f"[main] bf16 stack scores, block0_pipe vs fused_block0: max|d| = "
          f"{d_old:.3e} (atol {TOL_BF16_LOGITS['atol']})")
    check(d_old <= TOL_BF16_LOGITS["atol"],
          "the two bf16 block-0 kernels' scores disagree")

    s32_off = Scorer(model32, bf16=False, use_fused_frontend=False)
    s32_on = Scorer(model32, bf16=False, use_fused_frontend=True)
    s32_stack = Scorer(model32, bf16=False, use_fused_stack=True)
    ref_scores, _ = serve(s32_off, requests, {}, "f32, no kernels")
    f32_scores, f32_launches = serve(s32_on, requests, {
        "fused_frontend_fma": n_batches}, "f32 frontend kernel")
    f32_stack_scores, f32_stack_launches = serve(s32_stack, requests, {
        "fused_frontend_padded_fma": n_batches,
        "fused_block0_fma": n_batches}, "f32 stack")
    for tag, got_scores in (("f32 kernel", f32_scores),
                            ("f32 stack", f32_stack_scores)):
        err = max(np.abs(np.asarray(a) - np.asarray(b)).max()
                  for a, b in zip(got_scores, ref_scores))
        print(f"[main] {tag} scores vs f32 unfused scores: max|d| = "
              f"{err:.3e} (not gated; the golden gates below)")
    for tag, got_scores in (("kernel", scores), ("stack", stack_scores)):
        err = max(np.abs(np.asarray(a) - np.asarray(b)).max()
                  for a, b in zip(got_scores, ref_scores))
        print(f"[main] bf16 {tag} scores vs f32 unfused scores: max|d| = "
              f"{err:.3e} (atol {TOL_BF16_LOGITS['atol']})")
        check(err <= TOL_BF16_LOGITS["atol"],
              f"main-path {tag} scores off the f32 ones")

    golden = np.load(ROOT / "tests" / "goldens" / "aasist_golden.npz")
    xg = torch.from_numpy(golden["x"]).cuda()
    with torch.inference_mode():
        l_on = s32_on.model(xg)[1].float().cpu().numpy()
        l_off = s32_off.model(xg)[1].float().cpu().numpy()
        l_bf16 = scorer.model(xg)[1].float().cpu().numpy()
        l_stack = s32_stack.model(xg)[1].float().cpu().numpy()
        l_stack16 = stack.model(xg)[1].float().cpu().numpy()
    for tag, l32, l16 in (("kernel", l_on, l_bf16),
                          ("stack", l_stack, l_stack16)):
        d_onoff = np.abs(l32 - l_off).max()
        print(f"[main] f32 logits {tag} on vs off: max|d| = {d_onoff:.3e}")
        check(np.allclose(l32, l_off, **TOL_MODEL_ON_OFF),
              f"f32 logits with and without the {tag} disagree")
        d_gold = np.abs(l32 - golden["logits"]).max()
        print(f"[main] f32 {tag} logits vs reference golden: max|d| = "
              f"{d_gold:.3e}")
        check(np.allclose(l32, golden["logits"], **TOL_GOLDEN),
              f"f32 {tag} logits off the reference golden")
        check((np.argsort(l32[:, 1])
               == np.argsort(golden["logits"][:, 1])).all(),
              f"{tag}: bonafide-score order differs from the golden's")
        d_bf16 = np.abs(l16 - l32).max()
        print(f"[main] bf16 {tag} logits vs f32: max|d| = {d_bf16:.3e}")
        check(np.allclose(l16, l32, **TOL_BF16_LOGITS),
              f"bf16 {tag} logits off the f32 ones")
    del s32_on, s32_off, s32_stack, stack

    # ---------------------------------------------------------------- 5
    # utt/s over 5 batches of 128 requests: through score_waveforms,
    # pipelined two batches deep; the same requests a batch a call, so
    # that each batch is drained before the next is sent (the same host
    # work, padding included, and no overlap); and score_batch on rows
    # already padded, a batch a call (the earlier PRs' measure); the
    # device forward alone (CUDA events)
    waves = requests[1][:128] * 5
    rows = np.stack([pad_to_fixed(w) for w in requests[1][:128]])
    xb = torch.from_numpy(rows).cuda()
    # (use_fused_frontend, use_fused_stack, older_block0) of each mode; the
    # stack with the older block-0 kernel separates what the new one saves
    # from what its channels-last output saves the next blocks
    modes = {"stack": (False, True, False),
             "stack, older block 0": (False, True, True),
             "frontend kernel": (True, False, False),
             "both off": (False, False, False)}

    def set_mode(mode):
        (scorer.model.use_fused_frontend, scorer.model.use_fused_stack,
         old) = modes[mode]
        older_block0(scorer.model, old)

    thr = {m: [] for m in modes}
    thr_serial = {m: [] for m in modes}
    thr_rows = {m: [] for m in modes}
    fwd = {m: [] for m in modes}
    for mode in list(modes) + list(modes)[::-1]:
        set_mode(mode)
        scorer.score_waveforms(waves[:256])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorer.score_waveforms(waves)
        thr[mode].append(len(waves) / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for i in range(0, len(waves), 128):
            scorer.score_waveforms(waves[i:i + 128])
        thr_serial[mode].append(len(waves) / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for _ in range(5):
            scorer.score_batch(rows)
        thr_rows[mode].append(5 * 128 / (time.perf_counter() - t0))
        with torch.inference_mode():
            fwd[mode].append(cuda_ms(lambda: scorer.model(xb), 5, warmup=1))
    for mode, fname in (("frontend kernel", "profile_bf16_b128.txt"),
                        ("stack", "profile_bf16_b128_stack.txt")):
        set_mode(mode)
        profile_forward(scorer.model, xb, card, mode, fname)
    for mode in modes:
        print(f"[throughput] bf16 Scorer batch 128, {mode}: pipelined "
              f"{np.mean(thr[mode]):.1f} utt/s (runs "
              f"{[round(v, 1) for v in thr[mode]]}), a batch a call "
              f"{np.mean(thr_serial[mode]):.1f} utt/s (runs "
              f"{[round(v, 1) for v in thr_serial[mode]]}), padded rows a "
              f"batch a call {np.mean(thr_rows[mode]):.1f} utt/s (runs "
              f"{[round(v, 1) for v in thr_rows[mode]]}), forward "
              f"{np.mean(fwd[mode]):.3f} ms/batch on the device  [{card}]")

    # ---------------------------------------------------------------- 6
    del scorer, xb
    torch.cuda.empty_cache()
    probed = {"fused_frontend_dot_fm": fused_frontend_dot_fm,
              "fused_frontend_dot_bm": fused_frontend_dot_bm,
              "fused_frontend_head": fused_frontend_head,
              "fused_block0_constructs": bv.fused_block0_constructs,
              "fused_block0_stage": bv.fused_block0_stage,
              "fused_block0_cut": bv.fused_block0_cut,
              "fused_block0_epi": bv.fused_block0_epi,
              "pool3_time": tc.pool3_time,
              "pool3_time_major": tc.pool3_time_major,
              "selu_to_nchw": tc.selu_to_nchw,
              "stepcost": sc.stepcost,
              "mma_chain": mm.mma_chain}
    # each probe with the kernels it must launch; every count is set to 0
    # just before a probe and read just after it, and a kernel's launches
    # are the sum over the probes that run it
    dots = ("fused_frontend_dot_fm", "fused_frontend_dot_bm")
    probe_launches = dict.fromkeys(probed, 0)
    for probe, own in ((probe_frontend_variants, dots), (probe_fe_fix, dots),
                       (probe_feb0_ablate, ("fused_frontend_head",)),
                       (probe_b0_constructs, ("fused_block0_constructs",)),
                       (probe_b0_ablate, ("fused_block0_stage",
                                          "fused_block0_cut")),
                       (probe_b0_epi, ("fused_block0_epi",)),
                       (probe_tail_constructs, ("pool3_time",
                                                "pool3_time_major",
                                                "selu_to_nchw")),
                       (probe_stepcost, ("stepcost",)),
                       (probe_mxu_shapes, ("mma_chain",))):
        pname = probe.__name__.rsplit(".", 1)[-1]
        print(f"[probe] {pname} --iters 3")
        for fn in probed.values():
            fn.launches = 0
        rc = probe.main(["--iters", "3"])
        counts = {name: fn.launches for name, fn in probed.items()}
        check(rc == 0, f"{pname} returned {rc}")
        print(f"[probe] {pname} launches "
              f"{ {name: n for name, n in counts.items() if n} }")
        for name in own:
            check(counts[name] > 0, f"{name} was not launched by {pname}")
        for name, n in counts.items():
            probe_launches[name] += n
    print(f"[probe] launches {probe_launches}")

    # ---------------------------------------------------------------- 7
    # the Scorer's kernels: each entry's launches are those of the main-path
    # run that takes it (phase 4: the bf16 paths for the new kernels and
    # the older bf16 block 0, the f32 paths for the CUDA-core kernels, whose
    # entries also carry their bf16 numbers, read in phase 3)
    s16, s32 = stack_results["bfloat16"], stack_results["float32"]
    kernels = [
        {"name": "fused_frontend_dot_plain", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/frontend_dot.cu",
         "replaces": "aasist_tpu/ops/fused_frontend.py:79",
         "launches": launches["fused_frontend_dot_plain"],
         **dot_plain_results["bfloat16"], "dtype": "bfloat16",
         "shape": [128, 64600], "path": "bf16 default"},
        {"name": "fused_frontend_dot_padded", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/frontend_dot.cu",
         "replaces": "tools/fused_stack.py:180",
         "launches": stack_launches["fused_frontend_dot_padded"],
         **s16["fused_frontend_dot_padded"], "dtype": "bfloat16",
         "shape": [128, 64600], "path": "bf16 stack"},
        {"name": "block0_pipe", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/block0_pipe.cu",
         "replaces": "tools/fused_stack.py:250",
         "launches": stack_launches["block0_pipe"], **s16["block0_pipe"],
         "phases_ms": phases.get("block0_pipe"), "dtype": "bfloat16",
         "shape": [128, 64600], "path": "bf16 stack"},
        {"name": "fused_frontend", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/fused_frontend.cu",
         "replaces": "aasist_tpu/ops/fused_frontend.py:79",
         "launches": f32_launches["fused_frontend_fma"],
         **results["bfloat16"], "dtype": "bfloat16", "shape": [128, 64600],
         "path": "f32 frontend kernel", "float32": results["float32"]},
        {"name": "fused_frontend_padded", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/fused_frontend.cu",
         "replaces": "tools/fused_stack.py:180",
         "launches": f32_stack_launches["fused_frontend_padded_fma"],
         **s16["fused_frontend_padded"], "dtype": "bfloat16",
         "shape": [128, 64600], "path": "f32 stack",
         "float32": s32["fused_frontend_padded"]},
        {"name": "fused_block0", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/fused_block0.cu",
         "replaces": "tools/fused_stack.py:250",
         "launches": old_launches["fused_block0_mma"], **s16["fused_block0"],
         "phases_ms": phases.get("fused_block0"), "dtype": "bfloat16",
         "shape": [128, 64600],
         "path": "bf16 stack with the older block 0 (chip_smoke.py)",
         "float32": {**s32["fused_block0"], "launches":
                     f32_stack_launches["fused_block0_fma"]}},
    ]
    probes = {"fused_frontend_dot_fm": "tools/probe_frontend_variants.py:62",
              "fused_frontend_dot_bm": "tools/probe_fe_fix.py:43"}
    for name, where in probes.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "aasist_tpu_torch/csrc/frontend_dot.cu",
            "replaces": where, "launches": probe_launches[name],
            **dot_results[name], "dtype": "bfloat16", "shape": [128, 64600]})
    kernels.append({
        "name": "fused_frontend_head", "route": "cuda",
        "source": "aasist_tpu_torch/csrc/frontend_head.cu",
        "replaces": "tools/probe_feb0_ablate.py:69",
        "launches": probe_launches["fused_frontend_head"],
        **head_results["bfloat16"], "dtype": "bfloat16",
        "shape": [128, 64600], "float32": head_results["float32"]})
    # the block-0 variants: one entry per wrapper, its numbers those of the
    # variant named in "variant", every variant's under "variants"
    for fam, head, where in (
            ("fused_block0_constructs", "all",
             "tools/probe_b0_constructs.py:29"),
            ("fused_block0_stage", "conv2", "tools/probe_b0_ablate.py:32"),
            ("fused_block0_epi", "vA", "tools/probe_b0_epi.py:41")):
        kernels.append({
            "name": fam, "route": "cuda",
            "source": "aasist_tpu_torch/csrc/fused_block0.cu",
            "replaces": where, "launches": probe_launches[fam],
            **variant_results[fam][head], "variant": head,
            "dtype": "bfloat16", "shape": [128, 64600],
            "variants": variant_results[fam]})
    for name, label, where, shape, real in (
            ("pool3_time", "pool3_time staged",
             "tools/probe_tail_constructs.py:58",
             [64, 32, 23, 4608], [128, 32, 23, 21489]),
            ("pool3_time_major", "pool3_time_major",
             "tools/probe_tail_constructs.py:68",
             [64, 32, 4608, 23], [128, 32, 21489, 23]),
            ("selu_to_nchw", "selu_to_nchw",
             "tools/probe_tail_constructs.py:111",
             [32, 24, 64, 4608], [32, 24, 128, 21489])):
        entry = {
            "name": name, "route": "cuda",
            "source": "aasist_tpu_torch/csrc/tail_constructs.cu",
            "replaces": where, "launches": probe_launches[name],
            **tail_results[(label, "bfloat16", 64)], "dtype": "bfloat16",
            "shape": shape, "float32": tail_results[(label, "float32", 64)],
            "block0_size": {"shape": real,
                            **tail_results[(label, "bfloat16", 128)]}}
        if name == "selu_to_nchw":
            entry["variant"] = "vector (staged at block 0's size)"
            entry["staged"] = {
                d: tail_results[("selu_to_nchw staged", d, 64)]
                for d in ("bfloat16", "float32")}
        if name == "pool3_time":
            entry["variant"] = "staged"
            entry["direct"] = {
                "bfloat16": tail_results[("pool3_time direct", "bfloat16",
                                          64)],
                "float32": tail_results[("pool3_time direct", "float32",
                                         64)],
                "block0_size": tail_results[("pool3_time direct",
                                             "bfloat16", 128)]}
        kernels.append(entry)
    # the probes' kernels: one entry each, the numbers of the variant named
    # in "variant" (mma_chain's a dot), every variant's under "variants"
    for name, head, src, where, variants in (
            ("stepcost", "matmul", "stepcost", "tools/probe_stepcost.py:53",
             step_results),
            ("mma_chain", "k128_m128", "mma_shapes",
             "tools/probe_mxu_shapes.py:50", mma_results)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aasist_tpu_torch/csrc/{src}.cu", "replaces": where,
            "launches": probe_launches[name], **variants[head],
            "variant": head, "dtype": "bfloat16", "variants": variants})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
