#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which raises (exit code 1) on failure:
  1. versions, the card's name and power limit; TF32 off for the f32 checks;
  2. build the thirteen CUDA sources from csrc/, the nineteen builds of
     fused_block0.cu (its timer build among them), the twenty-one of
     block0_pipe.cu (the plain one, timer, three timing cuts, the seven
     builds of the construct sets and the cast ladder, the five stages
     and the three probe cuts that the timing cuts do not already give,
     the bf16 epilogue's timer), the six builds of
     frontend_head_pipe.cu and the six of frontend_head.cu that the head
     probe runs, the three timing cuts of frontend_dot_wg.cu that the
     frontend probe runs, and the older build of stepcost.cu with nvcc,
     65 libraries at once (the seconds printed);
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shape (128, 64600) in float32 and bfloat16 and at B = 3,
     L = 16001 (the sinc frontend on a freq-masked bank there): the
     frontend, the CUDA-core kernel in both types, the tensor-core
     kernel's plain store in bf16 and in f32 the 3xTF32 kernel's and the
     CUDA-core redesign's (bit for bit the older kernel's, gated); the
     padded frontend likewise, then block 0 on its frame (in f32 the
     CUDA-core kernel and the 3xTF32 one, also on frames of four and six
     of its bands; in bf16 the older kernel
     and the warp-specialised one, with both kernels' phase times from
     their timer builds and the new one's timing cuts; the two bf16
     kernels must agree bit for bit, also on frames of two and three
     bands); kernel times in turns beside plain, cuDNN-chain and both
     bounds (f32: CUDA cores and 3xTF32), and in f32 each kernel's error
     against float64 (not gated);
     then the tensor-core
     frontend in its two probe layouts (bfloat16 only, also at the probes'
     B = 256) and the frontend + block-0 head (frontend_head_pipe.cu and
     the older frontend_head.cu in both types, and in bf16 the new
     source's half- and quarter-width builds, each under the head's gates,
     timed in turns; in f32 the plain version with TF32 on, printed as a
     control); then every variant of the block-0 kernels (bfloat16: the
     construct sets, the six stages (stock chains timed beside dma, fill
     and conv1) and the cast ladder on block0_pipe.cu and
     on the older kernel, each pair timed in turns, and the five timing
     cuts of both in turns) and the tail kernels (three pools; SELU +
     layout change on selu_nchw.cu, first at a T of each residue mod 8
     with its output filled with NaN and on bases off a 16-byte boundary,
     then beside the older builds, timed in turns with them, its
     timing-only cut and the stock chain; both types, one size with
     ragged tiles); then the step-cost kernel in its
     six modes at B = 128, T = 7168 and at a ragged geometry (its TMA
     build, and the older build's four modes that TMA took over, timed in
     turns with the stock call), and the chained-dot kernels (wgmma and
     the older mma.sync) at the twelve dot shapes at a visible eps, each
     with a planted fault its gate must tell, timed a dot in turns (the
     phase's seconds printed);
  4. the main paths, each with every kernel wrapper's launch count reset
     just before and read just after, and checked: Scorer.from_config(
     "configs/AASIST.conf", use_fused_stack=False) with the pretrained
     weights (bf16, the tensor-core frontend) serves 5 requests of 1-6 s,
     then 131 (one full and one ragged batch of 128), pipelined two batches
     deep; the default Scorer (the frontend + block-0 pair) serves the same
     requests with the new block 0, then with the older one; f32 Scorers
     without kernels, with the
     CUDA-core frontend redesign and with the 3xTF32 pair, then the last
     two with the older CUDA-core kernels, held to them, and the f32
     forwards timed
     with either.  bf16 scores are
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
     profile_bf16_b128_stack.txt); then aasist_tpu_torch.tools.
     profile_stages's cumulative cuts (frontend, blocks 0-5, the graph
     stack) on the frontend and stack routes, launch counts checked, the
     full cut's logits bit for bit the forward's, its ms beside the
     forward's (not gated);
  6. the eval pipeline through its entry point on the card: cli.main([
     "--config", C, "--eval"]) with configs/AASIST.conf and the pretrained
     weights, four ways (f32 without kernels, f32 with the CUDA-core
     frontend, bf16 with the tensor-core frontend, bf16 with the stack), on
     the synthetic corpora of the e2e goldens (48 utterances of seed 77 in
     FLAC, then 512 of seed 99 in WAV, made under chiprun_out/eval/ and
     removed after), each with the kernel wrappers' launch counts reset
     just before and read just after; f32 held to the goldens (a row whose
     score turns on a near-tie of node order in the model, to the golden or
     to the JAX package's reading of the other order), the kernels' scores to the f32 ones and the bf16 ones to a Scorer's
     of the same rows, the reports to what main printed; utt/s of each way
     over the 512 utterances, decode to metrics (the 512 corpus is kept
     for phase 8, the 48 for phase 10); then the repo's tools on those
     corpora: preflight_la on the 48 (no problem), verify_reference_parity
     in its synthetic mode on the 48 and with --big on the 512 for the
     five architectures (each must pass; no kernel on its f32 stock
     route), bench_loader and bench_decode with their reps cut (printed;
     all in chiprun_out/tools.json with phase 5's cuts);
  7. the nine probes through their entry points
     (aasist_tpu_torch.tools.probe_frontend_variants, probe_fe_fix,
     probe_feb0_ablate, probe_b0_constructs, probe_b0_ablate, probe_b0_epi,
     probe_tail_constructs, probe_stepcost, probe_mxu_shapes), each with
     the kernels' launch counts reset just before it and read just after;
     a probe that did not launch each of its kernels fails;
  8. the rest of the zoo at full width (AASIST2, RawGAT-ST, RawNet2 with
     the goldens' seeded reference weights, loaded through
     utils/torch_compat.py; AASIST-Robust with seeded weights): the f32
     forward against the goldens' logits, with and without the frontend
     kernel; Scorers serving phase 4's requests at each architecture's
     default batch in f32, f32 with the CUDA-core frontend, bf16 with the
     tensor-core frontend and bf16 without (RawNet2: f32 and bf16), each
     with the kernels' launch counts reset just before and read just
     after, their pipelined utt/s and forward ms; cli.main([... "--eval"])
     over phase 6's 512 seed-99 utterances, f32 held to the e2e goldens,
     bf16 with the frontend kernel to the bf16 gate and bit for bit to a
     Scorer's scores of the same rows, AASIST-Robust's f32 kernel to its
     f32 run (numbers also in chiprun_out/zoo.json);
  9. training on the card: the PyTorch reference's train goldens
     (train_diff_{lr,rawnet2,aasist,aasist2,rawgatst}.npz: gradients,
     BatchNorm statistics and two Adam steps in float64 at 1e-8, the lr
     schedules at 1e-12, aasist_tpu_torch/tools/train_golden.py); one train
     step of configs/AASIST.conf at full width on the golden batch, f32
     (TF32 off) against float64 and mixed precision against f32, at the
     gates of TRAIN_TOL, and the f32 step with TF32 on, a control that
     must fail the f32 gate; the train step's device ms, utt/s, peak memory and
     idle share at batch 24 of the 96,000-sample window in both precisions,
     and an f32 dev-scoring batch's ms (printed, not gated); then
     cli.main(["--config", C, "--output_dir", D]) training configs/
     AASIST.conf with use_fused_frontend for two epochs on a 240-utterance
     synthetic corpus (made under chiprun_out/train/, removed after
     phase 10), in f32 and in mixed precision, with the launch counts
     reset before and read after each run: the train steps launch no kernel and each
     scoring batch launches the f32 frontend kernel once, the losses are
     finite, bn1 of encoder blocks 1-5 stays at its initial values, every
     file is written, --eval of weights/swa.npz reproduces the final eval
     scores, and --resume of a one-epoch run reaches the same step and
     epoch (numbers also in chiprun_out/train.json);
 10. data parallelism on two devices: the first two cards, or with one
     card that card twice (two replicas, two Gloo ranks, and NCCL in a
     group of one); which backend ran each part is printed (parallel_phase
     and the gates above it): a. fused_frontend_sharded at (128, 64600),
     bf16 and f32, bit for bit the one-device kernel's; b. the mesh Scorer
     on phase 4's requests (bf16 with the frontend kernel and with the
     stack, f32 with the frontend kernel) against the one-device Scorer,
     with utt/s of both; c. 2-rank --eval of the 48 seed-77 utterances
     (f32 and bf16 with the frontend kernel) against phase 6's one-process
     runs, with utt/s and each rank's batcher seconds; d. 2-rank training
     of configs/AASIST.conf at batch 24 = 2 x 12, two steps, against one
     process (and a per-rank-BatchNorm control that must fail the gate);
     e. the robust extras: one mixup + PGD step (the statistics of the
     clean forward alone, the PGD bound and loss increase, ms against a
     mixup step), then configs/AASIST-Robust.conf with use_mixup and
     adv_training through cli.main for phase 9's two epochs on 1 and 2
     ranks; f. the dry run (tools/dryrun_multigpu.py) on 2 ranks; g.
     utils/profiling.trace around 8 direct launches of a ctypes kernel
     and around two mesh-Scorer batches: every launch the wrappers counted
     in the trace, and its annotate span (numbers also in
     chiprun_out/parallel.json); ranks are this script run as
     "chip_smoke.py --worker cli|train ...";
 11. one JSON line describing every ported kernel (the frontend kernels'
     launches on the zoo's paths under "zoo_launches", every kernel's in
     phase 9's training runs under "train_launches", in phase 10's runs,
     every rank's summed, under "parallel_launches"), the card's line,
     and last the device JSON line.
"""

from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "aasist_tpu_torch").is_dir():
    sys.exit(f"no aasist_tpu_torch package beside {__file__}: run it from a "
             "checkout of the repository")
sys.path.insert(0, str(ROOT))
from aasist_tpu_torch.tools._common import (  # noqa: E402
    NODE_ORDER_TIES, ZOO_NODE_ORDER_TIES)

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
# The wgmma frontend (csrc/frontend_dot_wg.cu) against the mma.sync one
# (csrc/frontend_dot.cu): both round one f32 sum of the same bf16 products,
# taken in another order, and the new one's SELU takes __expf where the
# older calls expm1f, so an element may differ by one bf16 ulp where its
# value lies near a rounding boundary.  Where |.|, the BatchNorm shift and
# SELU leave a value near zero, that f32 noise (a few 1e-7) is many ulps of
# the value: such elements are held to this share of max|older| instead.
DOT_NEAR_ZERO = 1e-5
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


def ulp_excess(new, old):
    """(elements of ``new`` more than a bf16 ulp of the larger of the two
    and ``DOT_NEAR_ZERO`` of max|old| from ``old``, elements that differ at
    all, max|new - old|)."""
    import torch

    n, o = new.float(), old.float()
    d = (n - o).abs()
    ulp = torch.ldexp(torch.ones_like(d),
                      torch.frexp(torch.maximum(n.abs(), o.abs()))[1] - 8)
    over = (d > ulp) & (d > DOT_NEAR_ZERO * o.abs().max())
    return int(over.sum()), int((d > 0).sum()), d.max().item()


def bound_fields(bounds: dict, ms: float) -> dict:
    """The kernels line's bound keys from a bound's ``all_bounds`` dict:
    the least bound, what bounds it and its peak (float32: the CUDA cores'
    "float32" or the tensor cores' "tf32x3"), every candidate, and the
    kernel's share of the least one."""
    from aasist_tpu_torch.tools._common import least_bound

    bound, by, peak = least_bound(bounds)
    return dict(bound_ms=bound, bound_by=by, bound_peak=peak,
                bounds_ms={p: b for p, (b, _) in bounds.items()},
                bound_share=bound / ms)


def bound_text(bounds: dict, ms: float) -> str:
    f = bound_fields(bounds, ms)
    alts = ", ".join(f"{p} {b:.4f}" for p, b in f["bounds_ms"].items())
    return (f"bound {f['bound_ms']:.4f} ms ({f['bound_by']}, "
            f"{f['bound_peak']}; bounds {alts}), the kernel at "
            f"{100 * f['bound_share']:.1f} % of it")


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


# The f32 frontend path's kernel wrapper (ops/fused_frontend.py's float32
# route): the CUDA-core redesign, bit for bit the older CUDA-core kernel.
F32_FRONTEND = "fused_frontend_ffma"
# The eval pipeline (phase 6): each way's model_config keys, and the kernel
# wrappers it must launch once a batch (every other wrapper not at all).
EVAL_WAYS = {
    "f32": ({}, ()),
    "f32_frontend": ({"use_fused_frontend": True}, (F32_FRONTEND,)),
    "bf16_frontend": ({"dtype": "bfloat16", "use_fused_frontend": True},
                      ("fused_frontend_dot_plain",)),
    "bf16_stack": ({"dtype": "bfloat16", "use_fused_stack": True},
                   ("fused_frontend_dot_padded", "block0_pipe")),
}
# The e2e goldens' corpora (aasist_tpu_torch/data/synthetic.py), each with
# its golden and its score gate: the torch reference's scores, EER and min
# t-DCF (tests/test_e2e_differential.py:54-60,
# tools/verify_reference_parity.py:101).
EVAL_CORPORA = {
    "LA77": (dict(n_train=4, n_dev=4, n_eval=48, seed=77),
             "e2e_differential_golden.npz"),
    "LA99": (dict(n_train=2, n_dev=2, n_eval=512, seed=99,
                  audio_format="wav"), "e2e_diff_big_AASIST.npz"),
}
TOL_EVAL_SCORES = 1e-4
# Rows of a golden whose score turns on a near-tie of node order inside the
# model, each with its reading in the other order, are held by id to either
# (tools/_common.py: NODE_ORDER_TIES for phase 6's corpora,
# ZOO_NODE_ORDER_TIES for phase 8's architectures, each with its reason).
# bf16 scores against f32 ones: PERF.md section 2's 0.1 was set on logits of
# magnitude ~2 (5 %); a bf16 forward's error is relative, and the corpora's
# scores reach -7.6, so the allowance is 5 % of max(|f32|, 2).  The pipeline
# itself is held exactly: its bf16 scores equal the Scorer's on the same
# rows.
BF16_EVAL_REL = 0.05


def same_ranking(scores, ref, tie: float) -> bool:
    """argsort(scores) equals argsort(ref), but for swaps of utterances
    whose ``ref`` scores lie within ``tie`` of each other
    (tools/verify_reference_parity.py:233-239; tie 0 asks for equality)."""
    import numpy as np

    order, ref_order = np.argsort(scores), np.argsort(ref)
    swaps = order != ref_order
    return bool(np.all(np.abs(ref[order[swaps]] - ref[ref_order[swaps]])
                       < tie))


def eval_model():
    """The pretrained AASIST of configs/AASIST.conf on the card in f32."""
    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.weights import load_npz

    cfg = load_config(ROOT / "configs" / "AASIST.conf")
    model = load_npz(build_model(cfg.model_config),
                     ROOT / "checkpoints" / "AASIST.npz")
    return model.eval().to("cuda")


def gate_eval_scores(corpus: str, runs: dict, golden, waves, card: str
                     ) -> None:
    """Phase 6's gates on one corpus.  ``runs`` maps each way to (scores,
    EER, min t-DCF) from its score file; ``waves`` are the corpus's eval
    utterances in the golden's order.

    f32 without kernels against the golden: scores within 1e-4, the same
    ranking, EER and min t-DCF within 1e-10; a row of NODE_ORDER_TIES is
    held at 1e-4 to the golden or to the JAX package's reading of the
    other node order, every other row to the golden.  f32 with the
    frontend kernel within 2e-4 / 1e-4 rel of f32, same ranking; bf16
    within BF16_EVAL_REL of max(|f32|, 2) of f32, and equal to a Scorer's
    bf16 scores of the same rows."""
    import numpy as np

    from aasist_tpu_torch.serving import Scorer

    ref = np.asarray(golden["scores"], np.float64)
    f32, eer, tdcf = runs["f32"]
    ids = [str(u) for u in golden["utt_ids"]]
    for utt, other in NODE_ORDER_TIES.get(corpus, {}).items():
        i = ids.index(utt)
        print(f"[eval] {corpus} {utt} (node-order tie): f32 {f32[i]:.7f}, "
              f"golden {ref[i]:.7f}, the JAX package {other:.7f}")
        if abs(f32[i] - other) < abs(f32[i] - ref[i]):
            ref[i] = other
    tie = 0.0 if corpus == "LA77" else 2 * TOL_EVAL_SCORES
    d = np.abs(f32 - ref).max()
    print(f"[eval] {corpus} f32 vs the golden: max|d| = {d:.3e} (gate "
          f"{TOL_EVAL_SCORES}), EER {eer!r} vs {float(golden['eer'])!r}, "
          f"min t-DCF {tdcf!r} vs {float(golden['min_tdcf'])!r}")
    check(d < TOL_EVAL_SCORES, f"{corpus}: f32 scores off the reference")
    check(same_ranking(f32, ref, tie),
          f"{corpus}: f32 ranking differs from the reference's")
    check(abs(eer - float(golden["eer"])) < 1e-10
          and abs(tdcf - float(golden["min_tdcf"])) < 1e-10,
          f"{corpus}: f32 EER / min t-DCF off the golden's")
    got = runs["f32_frontend"][0]
    d = np.abs(got - f32).max()
    print(f"[eval] {corpus} f32 frontend kernel vs f32: max|d| = {d:.3e} "
          f"(atol {TOL_MODEL_ON_OFF['atol']}, rtol "
          f"{TOL_MODEL_ON_OFF['rtol']})")
    check(np.allclose(got, f32, **TOL_MODEL_ON_OFF)
          and same_ranking(got, f32, 2 * TOL_MODEL_ON_OFF["atol"]),
          f"{corpus}: f32 kernel scores off the f32 ones")
    for way, stack in (("bf16_frontend", False), ("bf16_stack", True)):
        got = runs[way][0]
        d = np.abs(got - f32)
        rel = d / np.maximum(np.abs(f32), 2.0)
        i = int(np.argmax(rel))
        print(f"[eval] {corpus} {way} vs f32: max|d| = {d.max():.3e}, "
              f"max |d| / max(|f32|, 2) = {rel[i]:.4f} (gate "
              f"{BF16_EVAL_REL}; utterance {i}, f32 {f32[i]:.4f}, bf16 "
              f"{got[i]:.4f}); EER {runs[way][1]!r}, min t-DCF "
              f"{runs[way][2]!r}")
        check(rel[i] <= BF16_EVAL_REL,
              f"{corpus}: {way} scores off the f32 ones")
        scorer = Scorer(eval_model(), use_fused_stack=stack)
        same = np.asarray(scorer.score_waveforms(waves), np.float64)
        del scorer
        print(f"[eval] {corpus} {way} vs a Scorer's bf16 scores of the same "
              f"rows: max|d| = {np.abs(same - got).max():.3e} (must be 0)"
              f"  [{card}]")
        check(np.array_equal(same, got),
              f"{corpus}: {way} scores differ from the Scorer's")


def bf16_gate_readings(corpus: str, waves, f32, card: str) -> None:
    """Where BF16_EVAL_REL sits: the bf16 gate's reading, max over the
    corpus of |bf16 - f32| / max(|f32|, 2), for the plain bf16 forward and
    for it with a planted fault in what the frontend kernels compute: the
    BN or the SELU of the epilogue skipped, the last band not stored, the
    output one frame late, or the accumulator kept in bf16 between 16-tap
    steps instead of f32.  The epilogue and store faults must read above
    the limit; the shift and the bf16 accumulator read about as the sound
    forward does, and are left to phase 3's check of each kernel against
    its plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from aasist_tpu_torch import nn
    from aasist_tpu_torch.data.dataset import pad_to_fixed

    def epilogue(m, h, bn=True, selu=True):
        h = nn.max_pool(h.abs()[:, None], (3, 3))
        h = nn.batch_norm(m.first_bn, h, axis=1) if bn else h
        return nn.selu(h) if selu else h

    def sinc(m, x):
        return F.conv1d(x[:, None], m.filterbank[:, None])

    def bf16_steps(m, x):
        bank = m.filterbank
        n_out = x.shape[1] - bank.shape[1] + 1
        acc = None
        for k0 in range(0, bank.shape[1], 16):
            w = bank[:, k0:k0 + 16]
            y = F.conv1d(x[:, None, k0:k0 + n_out + w.shape[1] - 1],
                         w[:, None])
            acc = y if acc is None else acc + y      # rounded to bf16
        return acc

    def unstored(m, x):
        h = epilogue(m, sinc(m, x))
        h[:, :, -1] = 0
        return h

    ways = {
        "sound": lambda m, x: epilogue(m, sinc(m, x)),
        "no_bn": lambda m, x: epilogue(m, sinc(m, x), bn=False),
        "no_selu": lambda m, x: epilogue(m, sinc(m, x), selu=False),
        "last_band_unstored": unstored,
        "one_frame_late": lambda m, x: torch.roll(
            epilogue(m, sinc(m, x)), 1, dims=3),
        "bf16_accumulator": lambda m, x: epilogue(m, bf16_steps(m, x)),
    }
    rows = torch.from_numpy(np.stack([pad_to_fixed(np.asarray(
        w, np.float32)) for w in waves])).cuda().to(torch.bfloat16)
    scale = np.maximum(np.abs(f32), 2.0)
    model = eval_model().to(torch.bfloat16)
    read = {}
    for way, frontend in ways.items():
        model.frontend = lambda x, bank, f=frontend: f(model, x)
        with torch.inference_mode():
            got = torch.cat([model(rows[i:i + 128])[1][:, 1]
                             for i in range(0, len(rows), 128)])
        read[way] = float((np.abs(got.float().cpu().numpy() - f32)
                           / scale).max())
    del model
    print(f"[eval] {corpus} bf16 gate readings, max |bf16 - f32| / "
          f"max(|f32|, 2) (limit {BF16_EVAL_REL}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in read.items())
          + f"  [{card}]")
    for way, r in read.items():
        if way not in ("sound", "one_frame_late", "bf16_accumulator"):
            check(r > BF16_EVAL_REL,
                  f"{corpus}: the bf16 gate does not tell {way} ({r:.4f})")


def eval_pipeline(card: str, path_kernels: dict, keep=()) -> dict:
    """Phase 6: ``python -m aasist_tpu_torch.cli --config C --eval`` through
    ``cli.main`` on the card, the four ways of EVAL_WAYS on the seed-77
    corpus, then (timed, utt/s) on the seed-99 corpus, each with the kernel
    wrappers' launch counts set to 0 just before and read just after.
    Gates: those of ``gate_eval_scores``; the score file's utterances in
    the protocol's order; both reports written, equal, and their numbers
    those ``main`` printed.
    The corpora are made under chiprun_out/eval/ and removed at the end,
    but for those named in ``keep``; the configs, score files and reports
    stay.  Returns each way's kernel launches, summed over both corpora."""
    import contextlib
    import io
    import re
    import shutil

    import numpy as np
    import torch

    from aasist_tpu_torch import cli
    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.data import synthetic
    from aasist_tpu_torch.data.dataset import AudioStore
    from aasist_tpu_torch.evaluation.metrics import calculate_tdcf_eer
    from aasist_tpu_torch.evaluation.scorefile import read_score_file

    out = ROOT / "chiprun_out" / "eval"
    shutil.rmtree(out, ignore_errors=True)
    stock = json.loads((ROOT / "configs" / "AASIST.conf").read_text())
    launches = {way: {} for way in EVAL_WAYS}
    try:
        t0 = time.perf_counter()
        for corpus, (kw, _) in EVAL_CORPORA.items():
            synthetic.generate(out / corpus, **kw)
        print(f"[eval] corpora generated: "
              f"{ {c: kw['n_eval'] for c, (kw, _) in EVAL_CORPORA.items()} }"
              f" eval utterances, {time.perf_counter() - t0:.1f} s")
        for corpus, (kw, golden_name) in EVAL_CORPORA.items():
            golden = np.load(ROOT / "tests" / "goldens" / golden_name)
            n_eval = kw["n_eval"]
            runs = {}
            for way, (keys, own) in EVAL_WAYS.items():
                conf = copy.deepcopy(stock)
                conf.update(database_path=str(out / corpus),
                            model_path=str(ROOT / "checkpoints"
                                           / "AASIST.npz"))
                conf["model_config"].update(keys)
                path = out / f"{corpus}_{way}.conf"
                path.write_text(json.dumps(conf, indent=1))
                printed = io.StringIO()
                torch.cuda.synchronize()
                for fn in path_kernels.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    rc = cli.main(["--config", str(path), "--eval",
                                   "--output_dir", str(out / "exp")])
                wall = time.perf_counter() - t0
                counts = {k: fn.launches for k, fn in path_kernels.items()}
                check(rc == 0, f"cli.main returned {rc} ({corpus} {way})")
                cfg = load_config(path)
                run_dir = out / "exp" / cfg.model_tag(path.stem)
                rows = read_score_file(run_dir / cfg.eval_output)
                check([r[0] for r in rows] == [str(u) for u in
                                               golden["utt_ids"]],
                      f"{corpus} {way}: the score file's utterances")
                scores = np.asarray([r[3] for r in rows])
                check(bool(np.isfinite(scores).all()),
                      f"{corpus} {way}: non-finite scores")
                eer, tdcf = calculate_tdcf_eer(
                    run_dir / cfg.eval_output, cfg.asv_scores(),
                    printout=False)
                done = printed.getvalue().strip().splitlines()[-1]
                report = (run_dir / "t-DCF_EER.txt").read_text()
                check((run_dir / "loaded_model_t-DCF_EER.txt").read_text()
                      == report, f"{corpus} {way}: the two reports differ")
                r_eer = float(re.search(r"\tEER\t\t= +([0-9.]+) %",
                                        report).group(1))
                r_tdcf = float(re.search(r"min-tDCF\t\t= +([0-9.]+)",
                                         report).group(1))
                check(done == f"DONE. EER: {r_eer:.3f}%, min t-DCF: "
                      f"{r_tdcf:.5f}" and abs(r_eer - eer) < 1e-8
                      and abs(r_tdcf - tdcf) < 1e-8,
                      f"{corpus} {way}: report {r_eer} / {r_tdcf}, printed "
                      f"{done!r}, score file {eer} / {tdcf}")
                n_batches = -(-n_eval // 128)
                for name, n in counts.items():
                    want = n_batches if name in own else 0
                    check(n == want, f"{corpus} {way}: {name} launched {n} "
                          f"times, want {want} ({n_batches} batches)")
                    if n:
                        launches[way][name] = \
                            launches[way].get(name, 0) + n
                runs[way] = scores, eer, tdcf
                print(f"[eval] {corpus} {way}: {n_eval} utterances in "
                      f"{wall:.3f} s, {n_eval / wall:.1f} utt/s (decode, "
                      f"batching, forward, score file, metrics); EER "
                      f"{eer:.6f} %, min t-DCF {tdcf:.6f}; launches "
                      f"{ {k: v for k, v in counts.items() if v} }  "
                      f"[{card}]")
                print(f"[eval]   printed: {done}")
            # where a run's time goes, its host stages timed alone: the
            # batcher (decode, padding, batching), the model's build, weights
            # and copy to the card, and one report (the CLI writes two)
            t0 = time.perf_counter()
            n_rows = sum(len(x) for x, _, _ in
                         cli.build_loaders(cfg, "cuda", eval_only=True).eval)
            t_batcher = time.perf_counter() - t0
            t0 = time.perf_counter()
            model = eval_model().to(torch.bfloat16)
            torch.cuda.synchronize()
            t_model = time.perf_counter() - t0
            del model
            t0 = time.perf_counter()
            calculate_tdcf_eer(run_dir / cfg.eval_output, cfg.asv_scores(),
                               printout=False)
            t_report = time.perf_counter() - t0
            print(f"[eval] {corpus} host stages alone: batcher {t_batcher:.3f}"
                  f" s ({n_rows} rows), model build + weights + copy "
                  f"{t_model:.3f} s, one report {t_report:.3f} s  [{card}]")
            ids = [str(u) for u in golden["utt_ids"]]
            store = AudioStore(out / corpus / "ASVspoof2019_LA_eval")
            waves = [store.read(u) for u in ids]
            gate_eval_scores(corpus, runs, golden, waves, card)
            if corpus == "LA99":
                bf16_gate_readings(corpus, waves, runs["f32"][0], card)
    finally:
        for corpus in EVAL_CORPORA:
            if corpus not in keep:
                shutil.rmtree(out / corpus, ignore_errors=True)
    return launches


# profile_stages in phase 5: each Scorer mode's route and the kernel
# wrappers its cuts must launch (and no other)
STAGE_PATHS = {"frontend kernel": ("frontend", {"fused_frontend_dot_plain"}),
               "stack": ("stack", {"fused_frontend_dot_padded",
                                   "block0_pipe"})}


def profile_stages_phase(card: str, path_kernels: dict, model, xb, fwd,
                         set_mode) -> dict:
    """Phase 5's per-stage cuts: ``tools/profile_stages.py:profile`` on the
    Scorer's bf16 model at batch 128, on the frontend and stack routes,
    launch counts set to 0 just before and read just after; the full cut's
    logits must equal the model's own forward's bit for bit, and its ms is
    printed beside the phase's forward ms (no gate on the times)."""
    import numpy as np
    import torch

    from aasist_tpu_torch.tools import profile_stages

    out, t0 = {}, time.perf_counter()
    for mode, (path, kernels) in STAGE_PATHS.items():
        set_mode(mode)
        torch.cuda.synchronize()
        for fn in path_kernels.values():
            fn.launches = 0
        rows, logits = profile_stages.profile(model, xb, path)
        counts = {k: fn.launches for k, fn in path_kernels.items()
                  if fn.launches}
        with torch.inference_mode():
            want = model(xb)[1]
        for line in profile_stages.report(rows, len(xb), card):
            print(f"[stages] {path}: {line}")
        print(f"[stages] {path}: the full cut {rows[-1].ms:.3f} ms against "
              f"the phase's forward {np.mean(fwd[mode]):.3f} ms; launches "
              f"{counts}  [{card}]")
        check(set(counts) == kernels,
              f"profile_stages {path}: launched {counts}, want {kernels}")
        check(torch.equal(logits, want),
              f"profile_stages {path}: the full cut's logits differ from "
              "the forward's")
        out[path] = {"batch": len(xb), "dtype": "bfloat16",
                     "cuts_ms": {r.name: r.ms for r in rows},
                     "forward_ms": float(np.mean(fwd[mode])),
                     "launches": counts}
    print(f"[stages] {time.perf_counter() - t0:.1f} s")
    return out


def tools_phase(card: str, path_kernels: dict, out: Path) -> dict:
    """Phase 6's tools on its corpora under ``out`` (LA77, LA99; none
    made here): preflight_la on LA77 (0 problems);
    verify_reference_parity in synthetic mode on LA77 and with --big on
    LA99 for the five architectures (each "pass": true, f32 on the stock
    route: no kernel launched); bench_loader and bench_decode on LA77 with
    their reps cut (printed, not gated).  Returns their readings."""
    import contextlib
    import io

    import torch

    from aasist_tpu_torch.tools import (bench_decode, bench_loader,
                                        preflight_la,
                                        verify_reference_parity as vrp)

    def run(tool, argv):
        printed = io.StringIO()
        torch.cuda.synchronize()
        for fn in path_kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = tool.main(argv)
        wall = time.perf_counter() - t0
        name = tool.__name__.rsplit(".", 1)[-1]
        counts = {k: fn.launches for k, fn in path_kernels.items()
                  if fn.launches}
        check(rc == 0, f"{name} {argv}: returned {rc}")
        check(not counts, f"{name}: launched {counts} on the stock route")
        return printed.getvalue().strip().splitlines()[-1], wall

    la77, la99 = out / "LA77", out / "LA99"
    lines = []
    t0 = time.perf_counter()
    problems = preflight_la.preflight(str(la77), out=lines.append)
    print(f"[tools] preflight_la LA77: {len(problems)} problems, "
          f"{len(lines)} checks, {time.perf_counter() - t0:.1f} s")
    check(problems == [], f"preflight_la LA77: {problems}")
    report = {"preflight_problems": problems}
    for mode, argv in (("synthetic", ["--corpus", str(la77)]),
                       ("big", ["--big", "--corpus", str(la99)])):
        line, wall = run(vrp, argv + ["--out_dir", str(out / "parity")])
        verdict = json.loads(line)
        per = verdict.get("archs", {"AASIST": verdict})
        for arch, v in per.items():
            ties = {u: (t["held_to"], round(t["score"], 7))
                    for u, t in v.get("node_order_ties", {}).items()}
            print(f"[tools] verify_reference_parity {mode} {arch}: pass "
                  f"{v['pass']}, max|d| {v['max_abs_score_diff']:.3e} (tol "
                  f"{v['score_tol']}), EER {v['eer_pct']!r} (golden "
                  f"{v['golden_eer_pct']!r}), min t-DCF {v['min_tdcf']!r}"
                  + (f", ties held {ties}" if ties else ""))
            check(v["pass"], f"verify_reference_parity {mode} {arch}")
        print(f"[tools] verify_reference_parity {mode}: {wall:.1f} s  "
              f"[{card}]")
        report[f"parity_{mode}"] = {"verdict": verdict, "seconds": wall}
    for tool, argv in ((bench_loader, [str(la77), "16", "5"]),
                       (bench_decode, [str(la77 / "ASVspoof2019_LA_eval"
                                           / "flac"), "5"])):
        line, wall = run(tool, argv)
        name = tool.__name__.rsplit(".", 1)[-1]
        print(f"[tools] {name}: {line}; {wall:.1f} s")
        report[name] = line
    return report


# The zoo (phase 8): each architecture's stock config, the golden holding
# its weights (the reference's seeded state dict, sd__*) and its f32 outputs,
# with the JAX package's tolerances on (logits, hidden) (tests/
# test_aasist2.py:59, tests/test_baseline_models.py:64-66), and its
# 512-utterance e2e golden (e2e_diff_big_{arch}.npz, f32 scores at
# TOL_EVAL_SCORES as phase 6 holds AASIST's).  AASIST-Robust has no golden
# (the reference crashes at forward): seeded weights, ZOO_ROBUST_SEED.
ZOO = {
    "AASIST2": ("AASIST2", "aasist2_golden.npz", (1e-3, 1e-3)),
    "RawGATST": ("RawGATST_baseline", "rawgatst_golden.npz", (5e-4, 5e-3)),
    "RawNet2": ("RawNet2_baseline", "rawnet2_golden.npz", (5e-4, 5e-3)),
    "AASIST-Robust": ("AASIST-Robust", None, None),
}
ZOO_ROBUST_SEED = 8
# Scorer ways: (bf16, use_fused_frontend, the kernel wrapper it launches
# once a batch, None for none); RawNet2 has no frontend kernel.
ZOO_WAYS = {
    "f32": (False, False, None),
    "f32_frontend": (False, True, F32_FRONTEND),
    "bf16_frontend": (True, True, "fused_frontend_dot_plain"),
    "bf16": (True, False, None),
}
# --eval ways: model_config keys, as EVAL_WAYS; AASIST-Robust, which has no
# e2e golden, is held with the kernel against itself without it.
ZOO_EVAL_WAYS = {
    "f32": ({}, None),
    "f32_frontend": ({"use_fused_frontend": True}, F32_FRONTEND),
    "bf16_frontend": ({"dtype": "bfloat16", "use_fused_frontend": True},
                      "fused_frontend_dot_plain"),
    "bf16": ({"dtype": "bfloat16"}, None),
}


def zoo_model(arch: str):
    """(model in f32 on the CPU with its weights, its stock config)."""
    import numpy as np
    import torch

    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.utils.torch_compat import fill_from_state_dict

    conf, golden, _ = ZOO[arch]
    cfg = load_config(ROOT / "configs" / f"{conf}.conf")
    if golden is None:
        # the module inits draw from torch's default generator, seeded here
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(ZOO_ROBUST_SEED)
            model = build_model(cfg.model_config)
            with torch.no_grad():
                for bn in model.modules():
                    if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                        bn.running_mean.normal_(0, 0.2)
                        bn.running_var.uniform_(0.5, 1.5)
                        bn.weight.uniform_(0.5, 1.5)
                        bn.bias.normal_(0, 0.2)
        return model, cfg
    data = np.load(ROOT / "tests" / "goldens" / golden)
    return fill_from_state_dict(build_model(cfg.model_config), {
        k[len("sd__"):]: data[k] for k in data.files
        if k.startswith("sd__")}), cfg


def bf16_rel(got, f32):
    """max |bf16 - f32| / max(|f32|, 2) over the rows: the bf16 gate's
    reading (BF16_EVAL_REL)."""
    import numpy as np

    return float((np.abs(got - f32) / np.maximum(np.abs(f32), 2.0)).max())


def zoo_phase(card: str, path_kernels: dict, requests, corpus: Path):
    """Phase 8: AASIST2, RawGAT-ST, RawNet2 and AASIST-Robust at full width
    on the card, through their entry points.

    For each: the f32 forward (with and without the frontend kernel) on
    the golden's input held to its logits and hidden, AASIST2's also with
    the golden's speaker embedding; ``Scorer`` serving phase 4's requests
    in each way of ZOO_WAYS at the architecture's default batch, launch
    counts set to 0 just before and read just after, the f32 kernel's
    scores within TOL_MODEL_ON_OFF of f32, bf16 within BF16_EVAL_REL,
    pipelined utt/s and device forward ms; ``cli.main([... "--eval"])``
    over the seed-99 corpus (512 WAV utterances; made here if phase 6 did
    not keep it; removed at the end) with the weights as ``.pth`` (the
    goldens' state dicts, through utils/torch_compat.py) or ``.npz``
    (AASIST-Robust), f32 held to the e2e golden, bf16 to the bf16 gate and
    bit for bit to a Scorer's scores of the same rows, AASIST-Robust's
    kernel to its f32 run.  Returns (launches, report): each arch's launch
    counts by run, and its numbers."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from aasist_tpu_torch import cli
    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.data import synthetic
    from aasist_tpu_torch.data.dataset import AudioStore, pad_to_fixed
    from aasist_tpu_torch.evaluation.metrics import (ScoringError,
                                                     calculate_tdcf_eer)
    from aasist_tpu_torch.evaluation.scorefile import (read_score_file,
                                                       write_score_file)
    from aasist_tpu_torch.serving import Scorer
    from aasist_tpu_torch.tools._common import cuda_ms
    from aasist_tpu_torch.weights import save_npz

    def reset():
        torch.cuda.synchronize()
        for fn in path_kernels.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in path_kernels.items()
                if fn.launches}

    out = corpus.parent
    if not corpus.is_dir():
        synthetic.generate(corpus, **EVAL_CORPORA["LA99"][0])
    launches, report = {}, {}
    try:
        for arch, (conf, golden_name, tols) in ZOO.items():
            t_arch = time.perf_counter()
            model, cfg = zoo_model(arch)
            has_fe = hasattr(model, "use_fused_frontend")
            runs = launches[arch] = {}
            rep = report[arch] = {}
            if golden_name:
                golden = np.load(ROOT / "tests" / "goldens" / golden_name)
                m32 = copy.deepcopy(model).cuda()
                x = torch.from_numpy(golden["x"]).cuda()
                cases = [("", {}, "logits", "hidden")]
                if arch == "AASIST2":
                    cases.append((" speaker-conditioned", {
                        "speaker_embedding": torch.from_numpy(
                            golden["spk"]).cuda()}, "logits_spk",
                        "hidden_spk"))
                for fe in ([False, True] if has_fe else [False]):
                    if has_fe:
                        m32.use_fused_frontend = fe
                    for tag, kw, lk, hk in cases:
                        with torch.inference_mode():
                            hidden, logits = (t.cpu().numpy()
                                              for t in m32(x, **kw))
                        dl = np.abs(logits - golden[lk]).max()
                        dh = np.abs(hidden - golden[hk]).max()
                        what = (f"{arch} f32{' frontend kernel' if fe else ''}"
                                f"{tag}")
                        print(f"[zoo] {what} vs the golden: logits max|d| "
                              f"{dl:.3e} (tol {tols[0]}), hidden {dh:.3e} "
                              f"(tol {tols[1]})")
                        check(np.allclose(logits, golden[lk], atol=tols[0],
                                          rtol=tols[0])
                              and np.allclose(hidden, golden[hk],
                                              atol=tols[1], rtol=tols[1]),
                              f"{what}: off the golden")
                        rep[f"{what} vs the golden"] = float(dl)
                del m32, x

            scores = {}
            for way, (bf16, fe, kernel) in ZOO_WAYS.items():
                if fe and not has_fe:
                    continue
                scorer = Scorer(model, bf16=bf16, use_fused_frontend=fe)
                scorer.warmup()
                b = scorer.batch_size
                n_batches = sum(-(-len(r) // b) for r in requests)
                reset()
                got = [scorer.score_waveforms(r) for r in requests]
                c = runs[f"scorer {way}"] = counts()
                check(c == ({kernel: n_batches} if kernel else {}),
                      f"{arch} Scorer {way}: launches {c}, want {kernel} "
                      f"{n_batches} times ({n_batches} batches of {b})")
                for r, sc in zip(requests, got):
                    check(len(sc) == len(r) and bool(np.isfinite(sc).all()),
                          f"{arch} Scorer {way}: scores")
                scores[way] = np.concatenate(got)
                timed = (requests[1][:128] * 10)[:5 * b]
                scorer.score_waveforms(timed[:2 * b])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scorer.score_waveforms(timed)
                ups = len(timed) / (time.perf_counter() - t0)
                xb = torch.from_numpy(np.stack(
                    [pad_to_fixed(w) for w in timed[:b]])).cuda()
                with torch.inference_mode():
                    fwd = cuda_ms(lambda: scorer.model(xb), 5, warmup=1)
                rep[way] = {"utt_per_s": ups, "forward_ms": fwd, "batch": b}
                print(f"[zoo] {arch} Scorer {way}, batch {b}: pipelined "
                      f"{ups:.1f} utt/s over {len(timed)} requests, forward "
                      f"{fwd:.3f} ms/batch on the device; launches on "
                      f"{sum(map(len, requests))} requests {c}  [{card}]")
                del scorer, xb
            f32 = scores["f32"]
            for way, got in scores.items():
                if way == "f32":
                    continue
                d = float(np.abs(got - f32).max())
                if way == "f32_frontend":
                    print(f"[zoo] {arch} Scorer f32 frontend kernel vs f32: "
                          f"max|d| = {d:.3e} (atol "
                          f"{TOL_MODEL_ON_OFF['atol']}, rtol "
                          f"{TOL_MODEL_ON_OFF['rtol']})")
                    check(np.allclose(got, f32, **TOL_MODEL_ON_OFF),
                          f"{arch}: f32 kernel scores off the f32 ones")
                else:
                    rel = bf16_rel(got, f32)
                    print(f"[zoo] {arch} Scorer {way} vs f32: max|d| = "
                          f"{d:.3e}, max |d| / max(|f32|, 2) = {rel:.4f} "
                          f"(gate {BF16_EVAL_REL})")
                    check(rel <= BF16_EVAL_REL,
                          f"{arch}: Scorer {way} scores off the f32 ones")
                rep[way]["vs_f32"] = d
            torch.cuda.empty_cache()

            # --eval over the 512 utterances
            weights = out / f"zoo_{arch}" \
                f"{'.pth' if golden_name else '.npz'}"
            if golden_name:
                torch.save({k[len("sd__"):]: torch.from_numpy(golden[k])
                            for k in golden.files if k.startswith("sd__")},
                           weights)
                ways = (["f32", "bf16_frontend"] if has_fe
                        else ["f32", "bf16"])
            else:
                save_npz(model, weights)
                ways = ["f32", "f32_frontend"]
            stock = json.loads((ROOT / "configs" / f"{conf}.conf")
                               .read_text())
            big = np.load(ROOT / "tests" / "goldens"
                          / EVAL_CORPORA["LA99"][1])
            ids = [str(u) for u in big["utt_ids"]]
            evals = {}
            for way in ways:
                keys, kernel = ZOO_EVAL_WAYS[way]
                c = copy.deepcopy(stock)
                c.update(database_path=str(corpus), model_path=str(weights))
                c["model_config"].update(keys)
                path = out / f"zoo_{arch}_{way}.conf"
                path.write_text(json.dumps(c, indent=1))
                printed = io.StringIO()
                reset()
                t0 = time.perf_counter()
                refused = None
                try:
                    with contextlib.redirect_stdout(printed):
                        rc = cli.main(["--config", str(path), "--eval",
                                       "--output_dir", str(out / "exp")])
                except ScoringError as e:
                    # the goldens' seeded, untrained weights score every
                    # utterance within 1e-3 (AASIST2: 0.3704-0.3712,
                    # RawNet2: a spread of 6e-5); bf16 rounds such scores
                    # to one or two values, which the reference's t-DCF
                    # refuses after the score file is written.  Only that
                    # refusal, and only with so few values, passes here.
                    if "hard decisions" not in str(e):
                        raise
                    refused, rc = str(e), 0
                wall = time.perf_counter() - t0
                n = runs[f"eval {way}"] = counts()
                check(rc == 0, f"cli.main returned {rc} ({arch} {way})")
                ecfg = load_config(path)
                run_dir = out / "exp" / ecfg.model_tag(path.stem)
                rows = read_score_file(run_dir / ecfg.eval_output)
                check([r[0] for r in rows] == ids,
                      f"{arch} {way}: the score file's utterances")
                meta = {r[0]: (r[1], r[2]) for r in rows}
                sc = np.asarray([r[3] for r in rows])
                check(bool(np.isfinite(sc).all()),
                      f"{arch} {way}: non-finite scores")
                if refused:
                    check(len(np.unique(sc)) < 3, f"{arch} {way}: "
                          f"{refused} with {len(np.unique(sc))} values")
                    eer = tdcf = float("nan")
                    print(f"[zoo] {arch} --eval {way}: metrics refused "
                          f"({refused}): {len(np.unique(sc))} distinct "
                          f"scores in {sc.min():.7f} .. {sc.max():.7f}")
                else:
                    eer, tdcf = calculate_tdcf_eer(
                        run_dir / ecfg.eval_output, ecfg.asv_scores(),
                        printout=False)
                    done = printed.getvalue().strip().splitlines()[-1]
                    check(done == f"DONE. EER: {eer:.3f}%, min t-DCF: "
                          f"{tdcf:.5f}", f"{arch} {way}: printed {done!r}")
                batch = cli.default_eval_batch(
                    ecfg.model_config["architecture"], "cuda",
                    ecfg.batch_size)
                want = {kernel: -(-len(ids) // batch)} if kernel else {}
                check(n == want, f"{arch} --eval {way}: launches {n}, want "
                      f"{want}")
                evals[way] = sc, eer, tdcf
                rep[f"eval_{way}"] = {"utt_per_s": len(ids) / wall,
                                      "eer": eer, "min_tdcf": tdcf}
                print(f"[zoo] {arch} --eval {way}: {len(ids)} utterances in "
                      f"{wall:.3f} s, {len(ids) / wall:.1f} utt/s; EER "
                      f"{eer:.6f} %, min t-DCF {tdcf:.6f}; launches {n}  "
                      f"[{card}]")
            f32, eer, tdcf = evals["f32"]
            if golden_name:
                eg = np.load(ROOT / "tests" / "goldens" /
                             f"e2e_diff_big_{arch}.npz")
                check([str(u) for u in eg["utt_ids"]] == ids,
                      f"{arch}: the e2e golden's utterances")
                ref = np.asarray(eg["scores"], np.float64)
                ref_eer, ref_tdcf = float(eg["eer"]), float(eg["min_tdcf"])
                for utt, other in ZOO_NODE_ORDER_TIES.get(arch, {}).items():
                    i = ids.index(utt)
                    print(f"[zoo] {arch} {utt} (node-order tie): f32 "
                          f"{f32[i]:.7f}, golden {ref[i]:.7f}, the other "
                          f"order {other:.7f}")
                    if abs(f32[i] - other) < abs(f32[i] - ref[i]):
                        # the metrics the held scores give: that row's
                        # order can move the EER threshold
                        ref[i] = other
                        held = out / f"zoo_{arch}_held_reference.txt"
                        write_score_file(held, ids, ref.tolist(), meta)
                        ref_eer, ref_tdcf = calculate_tdcf_eer(
                            held, ecfg.asv_scores(), printout=False)
                        print(f"[zoo] {arch} the golden with {utt} in the "
                              f"other order: EER {ref_eer!r}, min t-DCF "
                              f"{ref_tdcf!r} (the golden's "
                              f"{float(eg['eer'])!r}, "
                              f"{float(eg['min_tdcf'])!r})")
                d = np.abs(f32 - ref)
                print(f"[zoo] {arch} --eval f32 vs the e2e golden: max|d| = "
                      f"{d.max():.3e} at {ids[int(np.argmax(d))]} (gate "
                      f"{TOL_EVAL_SCORES}), EER {eer!r} vs {ref_eer!r}, "
                      f"min t-DCF {tdcf!r} vs {ref_tdcf!r}")
                check(d.max() < TOL_EVAL_SCORES,
                      f"{arch}: f32 scores off the e2e golden")
                check(same_ranking(f32, ref, 2 * TOL_EVAL_SCORES),
                      f"{arch}: f32 ranking differs from the golden's")
                check(abs(eer - ref_eer) < 1e-10
                      and abs(tdcf - ref_tdcf) < 1e-10,
                      f"{arch}: f32 EER / min t-DCF off the golden's")
                rep["eval_f32_vs_golden"] = float(d.max())
                way = ways[1]
                got = evals[way][0]
                rel = bf16_rel(got, f32)
                scorer = Scorer(model, bf16=True)
                same = np.asarray(scorer.score_waveforms(
                    [AudioStore(corpus / "ASVspoof2019_LA_eval").read(u)
                     for u in ids]), np.float64)
                del scorer
                print(f"[zoo] {arch} --eval {way} vs f32: max |d| / "
                      f"max(|f32|, 2) = {rel:.4f} (gate {BF16_EVAL_REL}); "
                      f"vs a Scorer's bf16 scores of the same rows: max|d| "
                      f"= {np.abs(same - got).max():.3e} (must be 0)")
                check(rel <= BF16_EVAL_REL,
                      f"{arch}: --eval {way} off the f32 scores")
                check(np.array_equal(same, got),
                      f"{arch}: --eval {way} differs from the Scorer's")
                rep[f"eval_{way}"]["vs_f32"] = rel
            else:
                got = evals["f32_frontend"][0]
                d = np.abs(got - f32).max()
                print(f"[zoo] {arch} --eval f32 frontend kernel vs f32: "
                      f"max|d| = {d:.3e} (atol {TOL_MODEL_ON_OFF['atol']}, "
                      f"rtol {TOL_MODEL_ON_OFF['rtol']})")
                check(np.allclose(got, f32, **TOL_MODEL_ON_OFF)
                      and same_ranking(got, f32,
                                       2 * TOL_MODEL_ON_OFF["atol"]),
                      f"{arch}: --eval kernel scores off the f32 ones")
                rep["eval_f32_frontend"]["vs_f32"] = float(d)
            weights.unlink()
            del model
            torch.cuda.empty_cache()
            print(f"[zoo] {arch}: {time.perf_counter() - t_arch:.1f} s")
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
        for w in out.glob("zoo_*"):
            if w.suffix in (".pth", ".npz"):
                w.unlink()
    return launches, report


# Training (phase 9).  The one-step gates on configs/AASIST.conf at full
# width, the golden batch of train_diff_aasist.npz (4 x 64,600, a loss of
# ~11.6: noise the pretrained model calls spoof), dropout off, read as
# |g - g_ref| / |g_ref| over all gradients as one vector and |loss -
# loss_ref| / |loss_ref|:
#   f32 (TF32 off) against the card's float64 step.  block 0's conv
# weight gradients sum 2 million f32 products each, so the f32 gradients
# stand ~sqrt(2e6) f32 ulps off.  Sound readings: the card 3.103e-4 on the
# gradients (max over elements 1.564e-3 of max|g|, at
# encoder.0.conv2.weight) and 6.489e-8 on the loss (NVIDIA H100 80GB
# HBM3, 700.00 W); the CPU 1.566e-4 and 1.826e-7 (chip_smoke.
# train_step_readings on 8 cores).  The control is the same step with
# cuDNN's and cuBLAS's TF32 on (operands rounded to a 10-bit mantissa): the
# card 2.258e-2 on the gradients (max over elements 1.025e-2, at
# encoder.0.conv1.weight) and 4.096e-4 on the loss.  The gates, 3e-3 and
# 1e-4, are ten and a thousand times the sound readings and a seventh and a
# quarter of the control's, which must fail them; a wrong or missing term
# moves a gradient by its own size.
#   bf16 mixed precision against f32: every op of the forward and backward
# rounds to 2^-9 relative, BatchNorm's weights and statistics included (the
# JAX package's cast).  Sound readings: the card 2.147e-1 on the gradients
# (max over elements 3.856e-1, at GAT_layer_S.att_proj.weight) and 1.872e-2
# on the loss.  The gates are 0.5 (a gradient of the wrong sign reads 2, a
# missing one 1) and the JAX package's 10 % on the loss
# (tests/test_mixed_precision.py).
TRAIN_TOL = {"float32": (3e-3, 1e-4), "mixed_precision": (0.5, 0.1)}
# The training entry point's corpus (aasist_tpu_torch/data/synthetic.py,
# WAV): 240 train utterances, ten steps an epoch at the stock batch of 24,
# each cropped or tiled to the 96,000-sample train window; 48 dev and 48
# eval, two scoring batches each at the train batch.
TRAIN_CORPUS = dict(n_train=240, n_dev=48, n_eval=48, seed=101,
                    audio_format="wav")
TRAIN_RUNS = {"float32": {}, "mixed_precision": {"mixed_precision": "True"}}


def train_step_readings(device: str, card: str) -> dict:
    """One train step of configs/AASIST.conf with the pretrained weights on
    the golden batch, in float64, float32, float32 with TF32 on (the
    control, which must fail the f32 gate) and mixed precision, through
    ``train/loop.py:make_train_step`` (dropout off, Adam of the config);
    returns {way: (gradient reading, loss reading, ...)} against the gates
    of TRAIN_TOL."""
    import numpy as np
    import torch

    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.train.loop import make_train_step
    from aasist_tpu_torch.train.losses import weighted_cce
    from aasist_tpu_torch.train.optim import create_optimizer, make_schedule
    from aasist_tpu_torch.weights import load_npz

    cfg = load_config(ROOT / "configs" / "AASIST.conf")
    data = np.load(ROOT / "tests" / "goldens" / "train_diff_aasist.npz")
    cfg.optim_config.epochs, cfg.optim_config.steps_per_epoch = 1, 1
    grads, losses = {}, {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    for way, dtype, mp in (("float64", torch.float64, False),
                           ("float32", torch.float32, False),
                           ("tf32", torch.float32, False),
                           ("mixed_precision", torch.float32, True)):
        model = load_npz(build_model(cfg.model_config),
                         ROOT / "checkpoints" / "AASIST.npz")
        model = model.to(device, dtype).train()
        optimizer = create_optimizer(cfg.optim_config, model.parameters())
        step = make_train_step(
            model, lambda lg, y, d: weighted_cce(lg, y), optimizer,
            make_schedule(cfg.optim_config), seed=0, freq_aug=False,
            use_duration=False, mixed_precision=mp, dropout=False)
        x = torch.from_numpy(data["x1"]).to(device, dtype)
        y = torch.from_numpy(data["y1"]).to(device)
        if way == "tf32":
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
        try:
            loss, _ = step(x, y, torch.ones(len(y), device=device), 0)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
        losses[way] = loss.item()
        grads[way] = {n: p.grad.double().cpu() for n, p
                      in model.named_parameters() if p.grad is not None}
    out = {}
    for way, ref in (("float32", "float64"), ("tf32", "float64"),
                     ("mixed_precision", "float32")):
        names = sorted(grads[ref])
        got = torch.cat([grads[way][n].flatten() for n in names])
        want = torch.cat([grads[ref][n].flatten() for n in names])
        err = (got - want).abs()
        worst = names[int(torch.tensor([
            (grads[way][n] - grads[ref][n]).abs().max()
            for n in names]).argmax())]
        out[way] = ((err.norm() / want.norm()).item(),
                    abs(losses[way] - losses[ref]) / abs(losses[ref]),
                    (err.max() / want.abs().max()).item(), worst)
        g_tol, l_tol = TRAIN_TOL["float32" if way == "tf32" else way]
        print(f"[train] one step, {way} against {ref}: gradients "
              f"|g - g_ref| / |g_ref| {out[way][0]:.3e} (gate {g_tol:g}), "
              f"max|g - g_ref| / max|g_ref| {out[way][2]:.3e} (at {worst})"
              f", loss {out[way][1]:.3e} relative (gate {l_tol:g}); loss "
              f"{losses[way]:.8f}  [{card}]")
        passes = out[way][0] <= g_tol and out[way][1] <= l_tol
        if way == "tf32":
            check(not passes, f"the TF32 control passes the f32 gate, which "
                  f"so cannot tell a full-f32 step from it: {out[way]}")
        else:
            check(passes, f"one train step, {way} against {ref}: "
                  f"{out[way]}")
    check(set(grads["float32"]) == set(grads["float64"])
          == set(grads["tf32"]) == set(grads["mixed_precision"]),
          "the three steps give gradients to different leaves")
    return out


def train_step_timing(card: str) -> dict:
    """Device ms of one train step of configs/AASIST.conf at batch 24 of
    the 96,000-sample window (CUDA events, 5 steps after 2), train utt/s,
    peak memory, the device's idle share over 3 steps (torch.profiler),
    and one f32 dev-scoring batch (24 x 64,600, the frontend kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.tools._common import cuda_ms
    from aasist_tpu_torch.train.loop import make_train_step
    from aasist_tpu_torch.train.losses import weighted_cce
    from aasist_tpu_torch.train.optim import create_optimizer, make_schedule

    cfg = load_config(ROOT / "configs" / "AASIST.conf")
    cfg.optim_config.epochs, cfg.optim_config.steps_per_epoch = 1, 10
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(24, 96000, generator=g, device="cuda") * 0.05
    y = (torch.arange(24, device="cuda") % 2)
    d = torch.full((24,), 6.0, device="cuda")
    out = {}
    for way, mp in (("float32", False), ("mixed_precision", True)):
        torch.manual_seed(0)
        model = build_model(cfg.model_config).cuda().train()
        optimizer = create_optimizer(cfg.optim_config, model.parameters())
        step = make_train_step(
            model, lambda lg, yy, dd: weighted_cce(lg, yy), optimizer,
            make_schedule(cfg.optim_config), seed=0, freq_aug=False,
            use_duration=False, mixed_precision=mp)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(x, y, d, 0), iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                step(x, y, d, i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = sorted(((e.self_device_time_total / 3e3, e.count // 3,
                        e.key) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
        busy = 3 * sum(r[0] for r in rows)
        idle = max(0.0, 1 - busy / wall)
        out[way] = {"step_ms": ms, "utt_per_s": 24e3 / ms,
                    "peak_gib": peak, "idle_share": idle,
                    "top_kernels": [list(r) for r in rows[:12]]}
        print(f"[train] step {way}, batch 24 x 96000: {ms:.3f} ms device, "
              f"{24e3 / ms:.1f} utt/s, peak {peak:.2f} GiB; 3 steps under "
              f"the profiler: window {wall:.3f} ms, device busy "
              f"{busy:.3f} ms, idle share {idle:.3f}  [{card}]")
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        with open(ROOT / "chiprun_out" / f"profile_train_{way}.txt",
                  "w") as f:
            f.write(f"{card}\nms a step by kernel, 3 steps, window "
                    f"{wall:.3f} ms, busy {busy:.3f} ms\n")
            for k_ms, n, key in rows:
                f.write(f"{k_ms:10.3f} ms  {n:5d}x  {key}\n")
        for k_ms, n, key in rows[:10]:
            print(f"[train]   {k_ms:9.3f} ms a step {n:4d}x  {key[:90]}")
    model.eval().use_fused_frontend = True
    xs = torch.randn(24, 64600, generator=g, device="cuda") * 0.05
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(xs), iters=5)
    out["dev_batch_ms"] = ms
    print(f"[train] dev scoring, f32 with the frontend kernel, batch 24 x "
          f"64600: {ms:.3f} ms a batch  [{card}]")
    return out


def train_entry_point(card: str, path_kernels: dict, keep: bool = False
                      ) -> dict:
    """Phase 9's training through ``cli.main(["--config", C,
    "--output_dir", D])``: configs/AASIST.conf at full width with
    ``use_fused_frontend``, two epochs on TRAIN_CORPUS (made under
    chiprun_out/train/, removed after), in f32 and in mixed precision, the
    kernel wrappers' launch counts set to 0 just before each run and read
    just after.  Gates: the train steps launch no kernel and every scoring
    batch (dev each epoch, eval on each new best dev EER and at the end)
    launches the f32 frontend kernel once; every epoch's loss finite; the
    bn1 of encoder blocks 1-5 at its initial weight 1 and bias 0; every
    file written; ``--eval`` of ``weights/swa.npz`` within TOL_EVAL_SCORES
    of the run's final eval scores; ``--resume`` of a one-epoch f32 run
    reaching the straight run's step and epoch and writing the final
    files.  ``keep`` leaves the corpus for phase 10.  Returns each run's
    launches and numbers."""
    import contextlib
    import functools
    import io
    import shutil

    import numpy as np
    import torch

    from aasist_tpu_torch import cli
    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.data import synthetic
    from aasist_tpu_torch.evaluation.scorefile import read_score_file
    from aasist_tpu_torch.train import loop

    def run_cli(argv):
        printed = io.StringIO()
        for fn in path_kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli.main({argv}) returned {rc}")
        return printed.getvalue(), wall, {
            k: fn.launches for k, fn in path_kernels.items()}

    out = ROOT / "chiprun_out" / "train"
    shutil.rmtree(out, ignore_errors=True)
    corpus = out / "LA"
    stock = json.loads((ROOT / "configs" / "AASIST.conf").read_text())
    report = {}
    try:
        t0 = time.perf_counter()
        synthetic.generate(corpus, **TRAIN_CORPUS)
        print(f"[train] corpus generated: {TRAIN_CORPUS}, "
              f"{time.perf_counter() - t0:.1f} s")
        for run, extra in TRAIN_RUNS.items():
            conf = copy.deepcopy(stock)
            conf.update(database_path=str(corpus), num_epochs=2, **extra)
            conf["model_config"]["use_fused_frontend"] = True
            path = out / f"AASIST_{run}.conf"
            path.write_text(json.dumps(conf, indent=1))
            cfg = load_config(path)
            printed, wall, counts = run_cli(
                ["--config", str(path), "--output_dir", str(out / "exp")])
            run_dir = out / "exp" / cfg.model_tag(path.stem)
            for name in ("config.conf", "metrics.jsonl", "metric_log.txt",
                         cfg.eval_output, "t-DCF_EER.txt",
                         "weights/best.npz", "weights/swa.npz",
                         "metrics/dev_score.txt",
                         "metrics/dev_t-DCF_EER_0epo.txt",
                         "metrics/dev_t-DCF_EER_1epo.txt",
                         "train_state/weights.npz",
                         "train_state/opt_state.npz",
                         "train_state/meta.json"):
                check((run_dir / name).is_file(), f"{run}: no {name}")
            meta = json.loads((run_dir / "train_state/meta.json")
                              .read_text())
            check((meta["step"], meta["epoch"]) == (20, 1),
                  f"{run}: train state at {meta}")
            scalars = [json.loads(line) for line in
                       (run_dir / "metrics.jsonl").read_text().splitlines()]
            losses = [s["value"] for s in scalars if s["name"] == "loss"]
            check(len(losses) == 2 and bool(np.isfinite(losses).all()),
                  f"{run}: epoch losses {losses}")
            with np.load(run_dir / "train_state/weights.npz") as w:
                for i in range(1, 6):
                    pre = f"params/encoder/{i}/bn1/"
                    check(bool((w[pre + "weight"] == 1).all()
                               and (w[pre + "bias"] == 0).all()),
                          f"{run}: encoder block {i}'s bn1 moved")
            n_best = len(list((run_dir / "metrics").glob("t-DCF_EER_*")))
            batches = 2 * 2 + 2 * (n_best + 1)
            for name, n in counts.items():
                want = batches if name == F32_FRONTEND else 0
                check(n == want, f"{run}: {name} launched {n} times, want "
                      f"{want} (2 epochs x 2 dev batches, {n_best + 1} x 2 "
                      "eval batches; train steps none)")
            epochs = [s["value"] for s in scalars
                      if s["name"] == "epoch_seconds"]
            last = printed.strip().splitlines()[-1]
            check(last.startswith("Exp FIN. EER: "), f"{run}: {last!r}")
            # the SWA weights through --eval: the run's final scores
            printed_e, _, counts_e = run_cli(
                ["--config", str(path), "--eval", "--eval_model_weights",
                 str(run_dir / "weights/swa.npz"),
                 "--output_dir", str(out / f"eval_{run}")])
            got = read_score_file(out / f"eval_{run}"
                                  / cfg.model_tag(path.stem)
                                  / cfg.eval_output)
            want = read_score_file(run_dir / cfg.eval_output)
            check([r[:3] for r in got] == [r[:3] for r in want],
                  f"{run}: --eval scored other utterances")
            d_eval = float(np.abs(np.asarray([r[3] for r in got])
                                  - [r[3] for r in want]).max())
            check(d_eval <= TOL_EVAL_SCORES,
                  f"{run}: --eval of swa.npz off the final scores by "
                  f"{d_eval}")
            report[run] = {"launches": {k: v for k, v in counts.items()
                                        if v},
                           "wall_s": wall, "epoch_seconds": epochs,
                           "losses": losses, "final": last,
                           "swa_eval_max_abs_diff": d_eval,
                           "eval_launches": {k: v for k, v in
                                             counts_e.items() if v}}
            per_epoch = ", ".join(f"{e:.2f}" for e in epochs)
            print(f"[train] {run}: cli.main 2 epochs of 10 steps in "
                  f"{wall:.1f} s (epochs {per_epoch} s), losses {losses}; "
                  f"launches {report[run]['launches']}"
                  f"; --eval of swa.npz within {d_eval:.3e}; {last}  "
                  f"[{card}]")
        # --resume: one epoch of the f32 run, then the rest
        path = out / "AASIST_float32.conf"
        one = functools.partial(loop.run_training, max_epochs=1)
        real = loop.run_training
        loop.run_training = one
        try:
            run_cli(["--config", str(path), "--output_dir",
                     str(out / "resume")])
        finally:
            loop.run_training = real
        printed, wall, _ = run_cli(["--config", str(path), "--output_dir",
                                    str(out / "resume"), "--resume"])
        run_dir = out / "resume" / load_config(path).model_tag(path.stem)
        meta = json.loads((run_dir / "train_state/meta.json").read_text())
        check((meta["step"], meta["epoch"]) == (20, 1)
              and "epoch 000" not in printed and "epoch 001" in printed,
              f"--resume: train state at {meta}")
        for name in ("weights/swa.npz", "t-DCF_EER.txt",
                     "eval_scores_using_best_dev_model.txt"):
            check((run_dir / name).is_file(), f"--resume: no {name}")
        report["resume"] = {"meta": meta, "wall_s": wall,
                            "final": printed.strip().splitlines()[-1]}
        print(f"[train] --resume after epoch 0: step {meta['step']}, epoch "
              f"{meta['epoch']}, {wall:.1f} s; {report['resume']['final']}")
    finally:
        if not keep:
            shutil.rmtree(corpus, ignore_errors=True)
    return report


# Phase 10: data parallelism.  Two devices: the first two cards, or the one
# card twice (two replicas or two Gloo ranks on it, and a group of one on
# NCCL).  Gates, each with its reason:
# - the sharded frontend equals the one-device kernel bit for bit (the
#   kernels are row-independent);
# - the mesh Scorer's scores: f32 within TOL_MODEL_ON_OFF of the one-device
#   Scorer (the same forward on half batches, cuDNN's order may differ),
#   bf16 within phase 4's bf16 gate (TOL_BF16_LOGITS);
# - data-parallel --eval: the same utterances in the same order, f32 scores
#   within DP_EVAL_F32 of the one-process run's, bf16 within BF16_EVAL_REL
#   of max(|score|, 2) (phase 6's bf16 allowance), EER and min t-DCF within
#   DP_EVAL_METRICS;
# - data-parallel training (DP_TRAIN_TOL): two Adam steps of AASIST.conf.
#   The first step's BatchNorm statistics and loss differ from the
#   one-process run's by f32 rounding only (the global statistics summed
#   in another order), 1e-4 of their largest magnitude; the parameters
#   after two steps by at most two Adam steps of lr 1e-4 each (Adam's
#   normalised update turns a rounding-level difference of a near-zero
#   gradient, a conv bias before its BatchNorm, into up to a whole step of
#   the other sign, which then shows in the next step's statistics: those
#   are printed, not gated).  The control takes each rank's BatchNorm
#   statistics alone and must fail.
DP_EVAL_F32 = 1e-5
DP_EVAL_METRICS = 1e-6
DP_TRAIN_TOL = {"stats": 1e-4, "loss": 1e-4, "params": 2 * 2 * 1e-4}
DP_BATCH = 24
# phase 10g's direct launches of one ctypes kernel inside a trace window
TRACE_DIRECT = 8
# the robust extras (phase 10e): the JAX package's defaults, on
ROBUST_KEYS = {"use_mixup": "True", "adv_training": "True"}


def path_kernel_fns() -> dict:
    """Every kernel wrapper a Scorer or eval path can reach, by name (the
    routers in front of them count nothing)."""
    from aasist_tpu_torch.ops import block0_f32 as b32
    from aasist_tpu_torch.ops import block0_pipe as bp
    from aasist_tpu_torch.ops import frontend_f32 as f32
    from aasist_tpu_torch.ops.frontend_variants import (
        fused_frontend_dot_padded, fused_frontend_dot_plain)
    from aasist_tpu_torch.ops.fused_frontend import fused_frontend_fma
    from aasist_tpu_torch.ops.fused_stack import (
        fused_block0_fma, fused_block0_mma, fused_frontend_padded_fma)
    return {"fused_frontend_dot_plain": fused_frontend_dot_plain,
            "fused_frontend_dot_padded": fused_frontend_dot_padded,
            "block0_pipe": bp.block0_pipe,
            "fused_frontend_ffma": f32.fused_frontend_ffma,
            "fused_frontend_tf32x3": f32.fused_frontend_tf32x3,
            "fused_frontend_padded_tf32x3": f32.fused_frontend_padded_tf32x3,
            "block0_tf32x3": b32.block0_tf32x3,
            "fused_frontend_fma": fused_frontend_fma,
            "fused_frontend_padded_fma": fused_frontend_padded_fma,
            "fused_block0_mma": fused_block0_mma,
            "fused_block0_fma": fused_block0_fma}


def dp_train_steps(ranks=None, sync: bool = True) -> dict:
    """Phase 10d's two train steps of configs/AASIST.conf at full width on
    one seeded batch of DP_BATCH x 96,000 (f32, TF32 off, dropout and
    freq_aug on), in one process or as ``ranks``' rows; ``sync=False``
    takes each rank's BatchNorm statistics alone (the control).  Returns
    the losses, each step's ms on the host clock (synchronised), the
    BatchNorm statistics after the first step (``step1.*``) and every
    parameter and buffer after the second."""
    import numpy as np
    import torch

    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.parallel import mesh
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.train.loop import make_train_step
    from aasist_tpu_torch.train.losses import make_loss_fn
    from aasist_tpu_torch.train.optim import create_optimizer, make_schedule

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(ROOT / "configs" / "AASIST.conf")
    cfg.optim_config.epochs, cfg.optim_config.steps_per_epoch = 1, 10
    device = ranks.device if ranks is not None else torch.device("cuda")
    torch.manual_seed(0)
    model = build_model(cfg.model_config).to(device).train()
    optimizer = create_optimizer(cfg.optim_config, model.parameters())
    loss_fn, use_duration = make_loss_fn(cfg.loss, cfg)
    step = make_train_step(
        model, loss_fn, optimizer, make_schedule(cfg.optim_config), seed=0,
        freq_aug=True, use_duration=use_duration, ranks=ranks)
    if not sync:
        mesh.sync_batch_norm(model, None)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((DP_BATCH, 96000)).astype(
        np.float32) * 0.05)
    y = torch.from_numpy(rng.integers(0, 2, DP_BATCH))
    d = torch.full((DP_BATCH,), 6.0)
    rows = (np.arange(DP_BATCH) if ranks is None else
            mesh.local_rows(DP_BATCH, ranks.rank, ranks.world))
    out = {"loss": [], "ms": []}
    for i in range(2):
        xs, ys, ds = (t[rows].to(device) for t in (x, y, d))
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss, _ = step(xs, ys, ds, i)
        out["loss"].append(float(loss))
        torch.cuda.synchronize(device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out.update({f"step1.{k}": b.detach().cpu().clone().numpy()
                        for k, b in model.named_buffers() if "running" in k})
    for k, v in [*model.named_parameters(), *model.named_buffers()]:
        out[k] = v.detach().cpu().numpy()
    return out


def worker(argv) -> int:
    """One rank of phase 10, started by ``parallel/launch.py:spawn``:
    ``cli ARGS`` runs ``cli.main(ARGS)``; ``train OUT SYNC BACKEND`` joins a
    group on BACKEND (also at world size 1) and runs ``dp_train_steps``,
    rank 0 writing OUT.  Prints a ``WORKER {json}`` line with the kernel
    wrappers' launches and the wall time."""
    import os

    import numpy as np
    import torch

    kernels = path_kernel_fns()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    task, args = argv[0], argv[1:]
    extra = {}
    if task == "cli":
        from aasist_tpu_torch import cli
        rc = cli.main(args)
    else:
        from aasist_tpu_torch.parallel import mesh
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        ranks = mesh.initialize_multihost(
            f"localhost:{os.environ['MASTER_PORT']}", world, rank,
            device=f"cuda:{rank % torch.cuda.device_count()}",
            backend=args[2], timeout_s=300)
        try:
            res = dp_train_steps(ranks, sync=args[1] == "1")
            extra = {"ms": res["ms"], "loss": res["loss"],
                     "backend": torch.distributed.get_backend()}
            if ranks.main:
                np.savez(args[0], **{k: np.asarray(v)
                                     for k, v in res.items()})
        finally:
            mesh.shutdown(ranks)
        rc = 0
    torch.cuda.synchronize()
    print("WORKER " + json.dumps({
        "rc": rc, "wall_s": time.perf_counter() - t0, **extra,
        "launches": {k: fn.launches for k, fn in kernels.items()}}),
        flush=True)
    return rc


def _worker_reports(outs) -> list:
    """The ``WORKER`` lines of each rank's output."""
    reps = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("WORKER ")]
        check(len(lines) == 1,
              f"a rank printed no WORKER line:\n{out[-3000:]}")
        reps.append(json.loads(lines[0][len("WORKER "):]))
    return reps


def _summed(reps) -> dict:
    out = {}
    for r in reps:
        for k, n in r["launches"].items():
            out[k] = out.get(k, 0) + n
    return out


def parallel_phase(card: str, path_kernels: dict, requests, weights):
    """Phase 10 (module docstring).  Returns (report, {run: summed kernel
    launches of its ranks or replicas})."""
    import re
    import shutil
    import subprocess

    import numpy as np
    import torch

    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.evaluation.scorefile import read_score_file
    from aasist_tpu_torch.ops.fused_frontend import (
        fused_frontend, fused_frontend_sharded)
    from aasist_tpu_torch.parallel import launch
    from aasist_tpu_torch.parallel.mesh import DataMesh
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.serving import Scorer
    from aasist_tpu_torch.tools._common import cuda_ms
    from aasist_tpu_torch.train import loop
    from aasist_tpu_torch.train.losses import weighted_cce
    from aasist_tpu_torch.train.optim import create_optimizer, make_schedule
    from aasist_tpu_torch.utils import profiling
    from aasist_tpu_torch.weights import load_npz

    cards = torch.cuda.device_count()
    two_cards = cards >= 2
    m = DataMesh(["cuda:0", "cuda:1"] if two_cards else ["cuda:0", "cuda:0"])
    rank_backend = "nccl" if two_cards else "gloo"
    print(f"[parallel] {cards} card(s): the mesh is {m}; 2 ranks run on "
          f"{'cuda:0 and cuda:1' if two_cards else 'cuda:0, both'} over "
          f"{rank_backend}" + ("" if two_cards else
                               "; NCCL runs a group of one"))
    report, runs = {"cards": cards, "mesh": str(m)}, {}
    conf_path = ROOT / "configs" / "AASIST.conf"

    def reset():
        torch.cuda.synchronize()
        for fn in path_kernels.values():
            fn.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in path_kernels.items()
                if fn.launches}

    # ---- a: the sharded frontend against the one-device kernel
    model32 = load_npz(build_model(load_config(conf_path).model_config),
                       weights).to("cuda")
    bn = model32.first_bn
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((128, 64600), generator=gen, device="cuda") * 0.1
    report["sharded_frontend"] = {}
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        xd = x.to(dtype)
        bank = model32.filterbank.detach().to(dtype)
        bn_p = {"weight": bn.weight.detach().to(dtype),
                "bias": bn.bias.detach().to(dtype)}
        bn_s = {"mean": bn.running_mean.to(dtype),
                "var": bn.running_var.to(dtype)}
        with torch.inference_mode():
            one = fused_frontend(xd, bank, bn_p, bn_s)
            reset()
            two = fused_frontend_sharded(xd, bank, bn_p, bn_s, mesh=m)
            n = counts()
        check(torch.equal(one, two), f"fused_frontend_sharded {dname} is "
              "not the one-device kernel's output bit for bit")
        ms_one = cuda_ms(lambda: fused_frontend(xd, bank, bn_p, bn_s), 10)
        ms_two = cuda_ms(lambda: fused_frontend_sharded(
            xd, bank, bn_p, bn_s, mesh=m), 10)
        report["sharded_frontend"][dname] = {
            "equal": True, "launches": n, "ms_one_device": ms_one,
            "ms_sharded": ms_two}
        print(f"[parallel] a. fused_frontend_sharded {dname} (128, 64600) "
              f"over {m}: equal to the one-device kernel bit for bit; "
              f"launches {n}; {ms_two:.4f} ms against {ms_one:.4f} ms on "
              f"one device  [{card}]")
    del x, xd, one, two, model32
    torch.cuda.empty_cache()

    # ---- b: the mesh Scorer against the one-device Scorer
    n_batches = sum(-(-len(r) // 128) for r in requests)
    waves = requests[1][:128] * 5
    report["mesh_scorer"] = {}
    for label, kw, own in (
            ("bf16 frontend", {"use_fused_stack": False},
             ("fused_frontend_dot_plain",)),
            ("bf16 stack", {},
             ("fused_frontend_dot_padded", "block0_pipe")),
            ("f32 frontend", {"bf16": False, "use_fused_frontend": True},
             (F32_FRONTEND,))):
        one = Scorer.from_config(conf_path, weights_path=weights, **kw)
        two = Scorer.from_config(conf_path, weights_path=weights, mesh=m,
                                 **kw)
        want = [one.score_waveforms(r) for r in requests]
        reset()
        got = [two.score_waveforms(r) for r in requests]
        n = counts()
        runs[f"mesh Scorer {label}"] = n
        for k in path_kernels:
            need = 2 * n_batches if k in own else 0
            check(n.get(k, 0) == need, f"mesh Scorer {label}: {k} launched "
                  f"{n.get(k, 0)} times, want {need} (two parts of "
                  f"{n_batches} batches)")
        d = max(float(np.abs(np.subtract(a, b)).max())
                for a, b in zip(got, want))
        if label.startswith("f32"):
            ok = all(np.allclose(a, b, **TOL_MODEL_ON_OFF)
                     for a, b in zip(got, want))
            gate = (f"atol {TOL_MODEL_ON_OFF['atol']}, rtol "
                    f"{TOL_MODEL_ON_OFF['rtol']}")
        else:
            ok = d <= TOL_BF16_LOGITS["atol"]
            gate = f"atol {TOL_BF16_LOGITS['atol']}"
        check(ok, f"mesh Scorer {label} off the one-device Scorer: {d}")
        ups = {"one device": [], "mesh": []}
        for who, sc in (("one device", one), ("mesh", two), ("mesh", two),
                        ("one device", one)):
            sc.score_waveforms(waves[:128])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc.score_waveforms(waves)
            ups[who].append(len(waves) / (time.perf_counter() - t0))
        report["mesh_scorer"][label] = {
            "max_abs_diff": d, "launches": n,
            "utt_per_s": {k: float(np.mean(v)) for k, v in ups.items()}}
        print(f"[parallel] b. mesh Scorer {label}, batch 128 over {m}: "
              f"max|mesh - one device| {d:.3e} ({gate}); launches {n}; "
              f"pipelined {np.mean(ups['mesh']):.1f} utt/s against "
              f"{np.mean(ups['one device']):.1f} on one device (runs "
              f"{ {k: [round(u, 1) for u in v] for k, v in ups.items()} })"
              f"  [{card}]")
        del one, two
        torch.cuda.empty_cache()

    # ---- g: profiling.trace: every launch a wrapper counts is in the
    # trace, first TRACE_DIRECT direct launches of one ctypes kernel, then
    # two mesh-Scorer batches (two parts each)
    from aasist_tpu_torch.ops import frontend_f32 as f32
    xg = torch.randn((4, 16001), generator=gen, device="cuda") * 0.1
    bank = load_npz(build_model(load_config(conf_path).model_config),
                    weights).filterbank.detach().to("cuda")
    ones = {"weight": torch.ones(1, device="cuda"),
            "bias": torch.zeros(1, device="cuda")}
    stats = {"mean": torch.zeros(1, device="cuda"),
             "var": torch.ones(1, device="cuda")}
    reset()
    direct = profiling.launches_in_trace(
        lambda: f32.fused_frontend_tf32x3(xg, bank, ones, stats),
        TRACE_DIRECT, "frontend_f32_kernel",
        ROOT / "chiprun_out" / "profile_direct")
    counted = counts().get("fused_frontend_tf32x3", 0)
    print(f"[parallel] g. profiling.trace of {TRACE_DIRECT} direct launches "
          f"of fused_frontend_tf32x3: {direct['found']} in the trace of "
          f"{counted - 1} counted in it (one launch before the window); "
          f"a kernel's start less its launch call {direct['skew_us']} us; "
          f"launch calls with no kernel (the warm-up's) "
          f"{direct['n_orphans']}  [{card}]")
    check(counted == TRACE_DIRECT + 1 and direct["found"] == TRACE_DIRECT,
          f"trace: {direct['found']} of the {TRACE_DIRECT} direct launches "
          f"of fused_frontend_tf32x3 ({json.dumps(direct)})")
    del xg, bank

    two = Scorer.from_config(conf_path, weights_path=weights, mesh=m,
                             use_fused_stack=False)
    rows = np.stack([np.resize(w, 64600) for w in requests[1][:128]])
    two.score_batch(rows)
    trace_dir = ROOT / "chiprun_out" / "profile_mesh"
    reset()
    with profiling.trace(trace_dir, devices=m.devices):
        with profiling.annotate("mesh_scorer_batch"):
            two.score_batch(rows)
            two.score_batch(rows)
    n = counts().get("fused_frontend_dot_plain", 0)
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "mesh_scorer_batch"]
    mesh_trace = profiling.read_trace(trace_dir / "trace.json",
                                      "frontend_dot_kernel", n)
    print(f"[parallel] g. profiling.trace of two mesh-Scorer batches: "
          f"{len(events)} events, the annotate span, "
          f"{mesh_trace['found']} of the {n} launches of the frontend "
          f"kernel; skew {mesh_trace['skew_us']} us, launch calls with no "
          f"kernel {mesh_trace['n_orphans']} "
          "(chiprun_out/profile_mesh/trace.json)")
    check(n == 4 and len(spans) >= 1 and mesh_trace["found"] == 4,
          f"trace: {len(spans)} annotate spans, {mesh_trace['found']} "
          f"frontend kernel launches of the {n} the wrapper counted (want 4 "
          f"of 4; {json.dumps(mesh_trace)})")
    report["trace"] = {"direct": direct, "spans": len(spans),
                       "mesh": mesh_trace, "counted": n,
                       "events": len(events)}
    del two
    torch.cuda.empty_cache()

    # ---- c: data-parallel --eval against phase 6's one-process runs
    out = ROOT / "chiprun_out" / "eval"
    report["dp_eval"] = {}
    try:
        for way in ("f32_frontend", "bf16_frontend"):
            path = out / f"LA77_{way}.conf"
            cfg = load_config(path)
            tag = cfg.model_tag(path.stem)
            outs = launch.spawn(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
                 "cli", "--config", str(path), "--eval", "--output_dir",
                 str(out / "dp2")], 2, timeout=600, cwd=ROOT)
            reps = _worker_reports(outs)
            n = _summed(reps)
            runs[f"DP --eval {way}"] = n
            kernel = (F32_FRONTEND if way.startswith("f32")
                      else "fused_frontend_dot_plain")
            check(n == {**{k: 0 for k in path_kernels}, kernel: 2},
                  f"DP --eval {way}: launches {n}, want {kernel} once a "
                  "rank")
            one = read_score_file(out / "exp" / tag / cfg.eval_output)
            got = read_score_file(out / "dp2" / tag / cfg.eval_output)
            check([r[:3] for r in got] == [r[:3] for r in one],
                  f"DP --eval {way}: other utterances or order")
            s1 = np.asarray([r[3] for r in one])
            s2 = np.asarray([r[3] for r in got])
            d = float(np.abs(s2 - s1).max())
            if way.startswith("f32"):
                check(d <= DP_EVAL_F32, f"DP --eval {way}: scores off the "
                      f"one-process run's by {d}")
            else:
                check(bool(np.all(np.abs(s2 - s1) <= BF16_EVAL_REL
                                  * np.maximum(np.abs(s1), 2.0))),
                      f"DP --eval {way}: scores off by {d}")
            metrics = []
            for run_dir in (out / "exp" / tag, out / "dp2" / tag):
                text = (run_dir / "t-DCF_EER.txt").read_text()
                metrics.append((
                    float(re.search(r"\tEER\t\t= +([0-9.]+) %",
                                    text).group(1)),
                    float(re.search(r"min-tDCF\t\t= +([0-9.]+)",
                                    text).group(1))))
            dm = max(abs(a - b) for a, b in zip(*metrics))
            check(dm <= DP_EVAL_METRICS, f"DP --eval {way}: EER / min t-DCF "
                  f"{metrics[1]} against {metrics[0]}")
            batcher = [float(v) for v in re.findall(
                r"rank \d: eval batcher ([0-9.]+) s", "".join(outs))]
            wall = reps[0]["wall_s"]
            report["dp_eval"][way] = {
                "max_abs_diff": d, "metrics": metrics, "launches": n,
                "wall_s": wall, "utt_per_s": 48 / wall,
                "batcher_s": batcher, "backend": rank_backend}
            print(f"[parallel] c. DP --eval {way}, 2 ranks over "
                  f"{rank_backend}: 48 utterances, the one-process run's ids "
                  f"in its order, max|score diff| {d:.3e}, EER / min t-DCF "
                  f"{metrics[1]} (one process {metrics[0]}); "
                  f"{48 / wall:.1f} utt/s (rank 0's cli.main {wall:.2f} s), "
                  f"batcher s by rank {batcher}; launches {n}  [{card}]")
    finally:
        shutil.rmtree(out / "LA77", ignore_errors=True)

    # ---- d: data-parallel training against one process, and the control
    ref = dp_train_steps()
    plan = ([("2 ranks", 2, True, "nccl"),
             ("control, per-rank BN", 2, False, "nccl")] if two_cards else
            [("2 ranks", 2, True, "gloo"),
             ("control, per-rank BN", 2, False, "gloo"),
             ("group of one", 1, True, "nccl")])
    report["dp_train"] = {"one_process_ms": ref["ms"],
                          "one_process_loss": ref["loss"], "runs": {}}
    npz = ROOT / "chiprun_out" / "dp_train.npz"
    for label, world, sync, backend in plan:
        outs = launch.spawn(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
             "train", str(npz), "1" if sync else "0", backend], world,
            timeout=600, cwd=ROOT)
        reps = _worker_reports(outs)
        check(all(r["backend"] == backend for r in reps),
              f"DP train {label}: backends {[r['backend'] for r in reps]}")
        n = _summed(reps)
        check(not any(n.values()), f"DP train {label}: launches {n}")
        with np.load(npz) as got:
            def rel(keys):
                return max(float(np.abs(got[k] - ref[k]).max())
                           / max(float(np.abs(ref[k]).max()), 1e-30)
                           for k in keys)
            stats = rel(k for k in got.files if k.startswith("step1."))
            stats2 = rel(k for k in got.files
                         if "running" in k and not k.startswith("step1."))
            params = max(float(np.abs(got[k] - ref[k]).max())
                         for k, _ in build_model(load_config(
                             conf_path).model_config).named_parameters())
            losses = [abs(a - b) / abs(b)
                      for a, b in zip(got["loss"], ref["loss"])]
        readings = {"stats": stats, "loss": losses[0], "params": params}
        passes = all(readings[k] <= DP_TRAIN_TOL[k] for k in readings)
        report["dp_train"]["runs"][label] = {
            **readings, "passes": passes, "backend": backend,
            "stats_step2": stats2, "loss_step2": losses[1],
            "ms": reps[0]["ms"], "loss": reps[0]["loss"]}
        print(f"[parallel] d. DP train {label} ({world} rank(s) over "
              f"{backend}), AASIST.conf batch {DP_BATCH} x 96000 f32, 2 "
              f"steps: BN statistics after step 1 {stats:.3e} of their max "
              f"(gate {DP_TRAIN_TOL['stats']:g}; after step 2 "
              f"{stats2:.3e}, not gated), step-1 loss {losses[0]:.3e} "
              f"relative (gate {DP_TRAIN_TOL['loss']:g}; step 2 "
              f"{losses[1]:.3e}), parameters after step 2 max|d| "
              f"{params:.3e} (gate {DP_TRAIN_TOL['params']:g}); step ms "
              f"{[round(v, 1) for v in reps[0]['ms']]} against one process "
              f"{[round(v, 1) for v in ref['ms']]}  [{card}]")
        if label.startswith("control"):
            check(not passes, f"the per-rank BatchNorm control passes the "
                  f"DP gate, which so cannot tell it: {readings}")
        else:
            check(passes, f"DP train {label} off the one-process run: "
                  f"{readings}")
    npz.unlink()
    del ref
    torch.cuda.empty_cache()

    # ---- e: the robust extras: one batch, then cli.main on 1 and 2 ranks
    rconf = json.loads((ROOT / "configs" / "AASIST-Robust.conf").read_text())
    rcfg_model = rconf["model_config"]
    robust = loop.RobustOptions(use_mixup=True, adv_training=True)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((24, 96000)).astype(
        np.float32) * 0.05).cuda()
    y = torch.from_numpy(rng.integers(0, 2, 24)).cuda()
    d = torch.full((24,), 6.0, device="cuda")
    cfg = load_config(conf_path)
    cfg.optim_config.epochs, cfg.optim_config.steps_per_epoch = 1, 10

    def step_for(opts):
        torch.manual_seed(0)
        model = build_model(rcfg_model).cuda().train()
        return model, loop.make_train_step(
            model, lambda lg, yy, dd: weighted_cce(lg, yy),
            create_optimizer(cfg.optim_config, model.parameters()),
            make_schedule(cfg.optim_config), seed=0, freq_aug=True,
            use_duration=False, robust=opts)

    clean_model, clean_step = step_for(loop.RobustOptions(use_mixup=True))
    rob_model, rob_step = step_for(robust)
    losses = [float(clean_step(x, y, d, 0)[0]), float(rob_step(x, y, d, 0)[0])]
    stat_diff = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                      1e-30)
                    for (k, a), (_, b) in zip(rob_model.named_buffers(),
                                              clean_model.named_buffers())
                    if "running" in k)
    check(stat_diff <= 1e-6 and all(np.isfinite(losses)),
          f"robust step: BN statistics {stat_diff} off the clean forward's "
          f"alone (gate 1e-6 of their max), losses {losses}")
    ms_plain = cuda_ms(lambda: clean_step(x, y, d, 1), 3, warmup=1)
    ms_robust = cuda_ms(lambda: rob_step(x, y, d, 1), 3, warmup=1)
    # the PGD check on a freshly built model in eval mode, as the JAX
    # package's test makes it (tests/test_robust_training.py:75-99)
    del clean_model, rob_model
    torch.manual_seed(0)
    model = build_model(rcfg_model).to(x.device).eval()

    def eval_loss(xb):
        return weighted_cce(model(xb)[1], y)

    x_adv = loop.pgd(eval_loss, x, robust)
    bound = float((x_adv - x).abs().max())
    with torch.no_grad():
        l_x, l_adv = float(eval_loss(x)), float(eval_loss(x_adv))
    check(0 < bound <= robust.adv_epsilon + 1e-6 and l_adv >= l_x,
          f"PGD: max|x_adv - x| {bound} (epsilon {robust.adv_epsilon}), "
          f"eval loss {l_adv} on x_adv against {l_x} on x")
    report["robust_batch"] = {
        "stat_diff": stat_diff, "losses": losses, "x_adv_bound": bound,
        "eval_loss_x": l_x, "eval_loss_x_adv": l_adv, "ms_plain": ms_plain,
        "ms_robust": ms_robust}
    print(f"[parallel] e. robust step (mixup + PGD, {robust.adv_steps} "
          f"steps) of AASIST-Robust.conf, batch 24 x 96000 f32: BN "
          f"statistics {stat_diff:.1e} of their max from the clean forward "
          f"alone; max|x_adv - x| {bound:.4f} (epsilon "
          f"{robust.adv_epsilon}); eval loss {l_adv:.5f} on x_adv, "
          f"{l_x:.5f} on x; {ms_robust:.1f} ms a step against {ms_plain:.1f}"
          f" for mixup alone ({ms_robust / ms_plain:.2f}x; adv_steps + 2 = "
          f"{robust.adv_steps + 2} forwards and backwards)  [{card}]")
    del model, x, x_adv
    torch.cuda.empty_cache()

    tdir = ROOT / "chiprun_out" / "train"
    rconf.update(database_path=str(tdir / "LA"), num_epochs=2, **ROBUST_KEYS)
    rconf["model_config"]["use_fused_frontend"] = True
    rpath = tdir / "AASIST-Robust_robust.conf"
    rpath.write_text(json.dumps(rconf, indent=1))
    report["robust_cli"] = {}
    try:
        for world in (1, 2):
            outs = launch.spawn(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
                 "cli", "--config", str(rpath), "--output_dir",
                 str(tdir / f"robust{world}")], world, timeout=900, cwd=ROOT)
            reps = _worker_reports(outs)
            run_dir = tdir / f"robust{world}" / load_config(
                rpath).model_tag(rpath.stem)
            scalars = [json.loads(line) for line in
                       (run_dir / "metrics.jsonl").read_text().splitlines()]
            ep_losses = [s["value"] for s in scalars if s["name"] == "loss"]
            secs = [s["value"] for s in scalars
                    if s["name"] == "epoch_seconds"]
            meta = json.loads((run_dir / "train_state/meta.json").read_text())
            last = outs[0].strip().splitlines()
            fin = [ln for ln in last if ln.startswith("Exp FIN.")]
            check(len(ep_losses) == 2 and bool(np.isfinite(ep_losses).all())
                  and (meta["step"], meta["epoch"]) == (20, 1) and fin,
                  f"robust cli.main, {world} rank(s): losses {ep_losses}, "
                  f"state {meta}")
            # every rank's scoring batches (2 x 2 dev, 2 for each eval on
            # a new best dev EER and at the end) launch the f32 frontend
            # kernel once each; the train steps none
            n_best = len(list((run_dir / "metrics").glob("t-DCF_EER_*")))
            n = _summed(reps)
            want = world * (2 * 2 + 2 * (n_best + 1))
            check(n == {**{k: 0 for k in path_kernels}, F32_FRONTEND: want},
                  f"robust cli.main, {world} rank(s): launches {n}, want "
                  f"{F32_FRONTEND} {want}")
            runs[f"robust training, {world} rank(s)"] = n
            report["robust_cli"][world] = {
                "losses": ep_losses, "epoch_seconds": secs,
                "ms_per_step": [1e3 * s / 10 for s in secs],
                "wall_s": reps[0]["wall_s"], "final": fin[0], "launches": n,
                "backend": rank_backend if world == 2 else None}
            print(f"[parallel] e. cli.main AASIST-Robust.conf with use_mixup"
                  f" and adv_training, 2 epochs of 10 steps, {world} "
                  f"rank(s){' over ' + rank_backend if world == 2 else ''}"
                  f": losses {ep_losses}, epochs "
                  f"{[round(v, 2) for v in secs]} s "
                  f"({[round(100 * v, 1) for v in secs]} ms a step); "
                  f"launches {n}; {fin[0]}  [{card}]")
    finally:
        shutil.rmtree(tdir, ignore_errors=True)

    # ---- f: the dry run on 2 ranks
    res = subprocess.run(
        [sys.executable, "-m", "aasist_tpu_torch.tools.dryrun_multigpu",
         "--nproc", "2"], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    check(res.returncode == 0 and "all phases passed" in res.stdout,
          f"dryrun_multigpu --nproc 2:\n{(res.stdout + res.stderr)[-4000:]}")
    for line in res.stdout.splitlines():
        if line.startswith("dryrun_multigpu"):
            print(f"[parallel] f. {line}")
    report["dryrun"] = [ln for ln in res.stdout.splitlines()
                        if ln.startswith("dryrun_multigpu")]
    return report, runs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    import torch.nn.functional as F

    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.data.dataset import pad_to_fixed
    from aasist_tpu_torch.ops import _build
    from aasist_tpu_torch.ops import block0_variants as bv
    from aasist_tpu_torch.ops import mma_shapes as mm
    from aasist_tpu_torch.ops import stepcost as sc
    from aasist_tpu_torch.ops import tail_constructs as tc
    from aasist_tpu_torch.ops import frontend_head as fh
    from aasist_tpu_torch.ops.frontend_head import (
        fused_frontend_head, fused_frontend_head_older,
        fused_frontend_head_reference)
    from aasist_tpu_torch.ops import block0_f32 as b32
    from aasist_tpu_torch.ops import block0_pipe as bp
    from aasist_tpu_torch.ops import frontend_f32 as f32
    from aasist_tpu_torch.ops import frontend_variants as fv
    from aasist_tpu_torch.ops.frontend_variants import (
        fused_frontend_dot_bm, fused_frontend_dot_bm_older,
        fused_frontend_dot_bm_reference, fused_frontend_dot_fm,
        fused_frontend_dot_fm_older, fused_frontend_dot_fm_reference,
        fused_frontend_dot_padded, fused_frontend_dot_padded_reference,
        fused_frontend_dot_plain)
    from aasist_tpu_torch.ops.fused_frontend import (
        fused_frontend_fma, fused_frontend_reference)
    from aasist_tpu_torch.ops.fused_stack import (
        fold_block0, fused_block0_fma, fused_block0_mma,
        fused_block0_reference, fused_frontend_padded,
        fused_frontend_padded_fma, fused_frontend_padded_reference)
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.serving import Scorer
    from aasist_tpu_torch.tools import (
        probe_b0_ablate, probe_b0_constructs, probe_b0_epi, probe_fe_fix,
        probe_feb0_ablate, probe_frontend_variants, probe_mxu_shapes,
        probe_stepcost, probe_tail_constructs)
    from aasist_tpu_torch.tools._common import (
        B0_BF16_EPILOGUES, HEAD_Y1_OWN_X0_TOL, b0_fault, b0_readings,
        block0_bound, bytes_bound, card_line, cuda_ms, f64_err,
        frontend_bound, head_bound, head_y1_excess, least_bound,
        max_abs_err, stage_bound, stepcost_bound, two_runs)
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
              + [bv.cut_defines(c, older=True) for c in bv.CUTS]):
        variants[json.dumps(d, sort_keys=True)] = d
    variants[json.dumps(bp.TIMER_DEFINES)] = bp.TIMER_DEFINES
    # the builds of block0_pipe.cu: the timer, the cuts, the probes'
    # construct sets, stages, cast ladder and cuts, the timer of the timed
    # sets
    pipe = [bp.TIMER_DEFINES] + [{"B0P_CUT": c}
                                 for c in bp.PIPE_CUTS.values()]
    for _, d in ([bv.constructs_build(*f) for f in construct_sets.values()]
                 + [bv.stage_build(st) for st in bv.STAGES]
                 + [bv.epi_build(v) for v in bv.EPI_VARIANTS]
                 + [bv.cut_build(c) for c in bv.CUTS]):
        if d and d not in pipe:
            pipe.append(d)
    for n in probe_b0_constructs.TIMED_SETS:
        d = bv.constructs_defines(*construct_sets[n])
        if d:
            pipe.append({**bp.TIMER_DEFINES, **d})
    # the head's builds: both sources' probe variants (their base builds
    # among them)
    heads = list(probe_feb0_ablate.builds().values())
    entries = [(n, None) for n in ("fused_frontend", "frontend_dot",
                                   "frontend_dot_wg",
                                   "frontend_f32", "frontend_ffma",
                                   "block0_f32", "tail_constructs",
                                   "selu_nchw", "stepcost", "mma_shapes",
                                   "mma_chain_wg", "block0_pipe")]
    entries += [("stepcost", sc.OLDER_DEFINES), ("selu_nchw", tc.CUT_DEFINES)]
    # the frontend probe's builds of frontend_dot_wg.cu (its default among
    # the entries above)
    entries += [e for e in probe_frontend_variants.builds().values() if e[1]]
    entries += heads
    entries += [("block0_pipe", d) for d in pipe]
    entries += [("fused_block0", d) for d in variants.values()]
    libs = _build.load_all(entries)
    print(f"[build] {len(libs)} libraries in parallel ({len(variants)} of "
          f"fused_block0.cu, {1 + len(pipe)} of block0_pipe.cu, 2 of "
          f"stepcost.cu, 2 of selu_nchw.cu, "
          f"{len(probe_frontend_variants.builds())} of "
          f"frontend_dot_wg.cu, {len(heads)} of frontend_head_pipe.cu and "
          f"frontend_head.cu): {time.perf_counter() - t0:.1f} s")
    for (_, defines), lib in zip(entries, libs):
        print(f"[build] {lib.path.name} {defines or ''}: nvcc "
              f"{lib.build_seconds:.1f} s")
        for line in lib.log.splitlines():
            if ("registers" in line or "spill" in line
                    or "wgmma" in line.lower()):
                print(f"[build]   {line.strip()}")

    # ---------------------------------------------------------------- 3
    t3 = time.perf_counter()
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
    # the CUDA-core frontend (both types), in bf16 the tensor-core
    # frontend's plain store and in f32 the 3xTF32 one and the CUDA-core
    # redesign (bit for bit the older kernel: gated), each against the
    # plain version; in f32 every kernel also against float64 (not gated)
    results = {}                       # fused_frontend_fma
    dot_plain_results = {}             # fused_frontend_dot_plain
    f32_new = {}                       # the f32 redesigns, by name
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
        else:
            kernels_here += [(k, getattr(f32, k), f32_new.setdefault(k, {}))
                             for k in ("fused_frontend_tf32x3",
                                       "fused_frontend_ffma")]
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
        if dname == "bfloat16":
            d = (outs["fused_frontend_fma"].float()
                 - outs["fused_frontend_dot_plain"].float()).abs().max()
            print(f"[kernel] {tag}: max|tensor-core - CUDA-core frontend| "
                  f"= {d.item():.3e} (not gated)")
        else:
            same = torch.equal(outs["fused_frontend_ffma"],
                               outs["fused_frontend_fma"])
            print(f"[kernel] {tag}: fused_frontend_ffma bit for bit "
                  f"fused_frontend_fma: {same}")
            check(same, f"fused_frontend_ffma differs from "
                  f"fused_frontend_fma, {tag}")
            e64 = {k: f64_err(o, fused_frontend_reference, x, bank, bn_p,
                              bn_s) for k, o in outs.items()}
            print(f"[kernel] {tag}: max|kernel - float64 plain|: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in e64.items())
                  + " (not gated)")
            if b == 128:
                results[dname]["f64_err"] = e64["fused_frontend_fma"]
                for k in f32_new:
                    f32_new[k][dname]["f64_err"] = e64[k]
        del outs, got
        if b == 128:
            plain = cuda_ms(
                lambda: fused_frontend_reference(x, bank, bn_p, bn_s), 10)
            libms = cuda_ms(lambda: library_chain(x, bank, bn_p, bn_s), 10)
            bounds = frontend_bound(b, length, 70, dname, all_bounds=True)
            bound, by, peak = least_bound(bounds)
            # in turns: each kernel timed twice, the second time in reverse
            # order
            runs = {k: [] for k, _, _ in kernels_here}
            for kname, fn, _ in kernels_here + kernels_here[::-1]:
                runs[kname].append(
                    cuda_ms(lambda: fn(x, bank, bn_p, bn_s), 20))
            for kname, fn, store in kernels_here:
                ms = float(np.mean(runs[kname]))
                store[dname].update(ms=ms, plain_ms=plain, library_ms=libms,
                                    **bound_fields(bounds, ms))
                print(f"[kernel] {kname} {tag}: kernel {ms:.4f} ms (runs "
                      f"{[round(v, 4) for v in runs[kname]]}), plain "
                      f"{plain:.4f} ms, cuDNN chain {libms:.4f} ms, "
                      f"{bound_text(bounds, ms)}  [{card}]")
            if dname == "float32":
                for k in f32_new:
                    f32_new[k][dname]["replaced_ms"] = float(
                        np.mean(runs["fused_frontend_fma"]))
        del x, ref
    torch.cuda.empty_cache()

    # the frontend + block-0 pair (at B = 3 on a freq-masked bank); block
    # 0's plain version is its cuDNN chain (conv1, BN, SELU, conv2,
    # downsample, add, max_pool2d).  The
    # padded frontend: the CUDA-core kernel in both types, the tensor-core
    # one in bf16, the CUDA-core redesign (bit for bit the older kernel:
    # gated) and the 3xTF32 one in f32; block 0: in f32 the CUDA-core
    # kernel and the 3xTF32 one, in bf16 the older kernel and the
    # warp-specialised one, on the frame of the route's frontend (bf16:
    # the tensor-core one, f32: the 3xTF32 one).  Times in turns (old, new,
    # new, old); in f32 each kernel also against float64 (not gated).
    stack_results = {"float32": {}, "bfloat16": {}}
    phases = {}
    for dname, b, length in [("float32", 128, 64600),
                             ("bfloat16", 128, 64600),
                             ("float32", 3, 16001), ("bfloat16", 3, 16001)]:
        dtype = getattr(torch, dname)
        bf16 = dname == "bfloat16"
        tag = f"{dname} B={b} L={length}{' masked' if b == 3 else ''}"
        x = (torch.randn((b, length), generator=gen, device="cuda")
             * 0.1).to(dtype)
        bank = model32.filterbank.detach().to("cuda", dtype).clone()
        if b == 3:
            bank[10:20] = 0
        bn_p, bn_s = bn_dicts(dtype)
        block = copy.deepcopy(model32.encoder[0]).to("cuda", dtype)
        res = stack_results[dname] if b == 128 else {}
        with torch.inference_mode():
            zr = fused_frontend_padded_reference(x, bank, bn_p, bn_s)
            shape = (b, 25, (length - 128) // 3 + 2)
            tol = TOL_F32 if dname == "float32" else TOL_BF16_KERNEL
            # the route's kernel last
            fe_kernels = [("fused_frontend_padded", fused_frontend_padded_fma)]
            fe_kernels += (
                [("fused_frontend_dot_padded", fused_frontend_dot_padded)]
                if bf16 else [("fused_frontend_padded_ffma",
                               f32.fused_frontend_padded_ffma),
                              ("fused_frontend_padded_tf32x3",
                               f32.fused_frontend_padded_tf32x3)])
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
                if not bf16:
                    res[kname]["f64_err"] = f64_err(
                        z, fused_frontend_padded_reference, x, bank, bn_p,
                        bn_s)
            if not bf16:
                same = torch.equal(frames["fused_frontend_padded_ffma"],
                                   frames["fused_frontend_padded"])
                print(f"[kernel] {tag}: fused_frontend_padded_ffma bit for "
                      f"bit fused_frontend_padded_fma: {same}")
                check(same, f"fused_frontend_padded_ffma differs from "
                      f"fused_frontend_padded_fma, {tag}")
                print(f"[kernel] {tag}: max|kernel - float64 plain|: "
                      + ", ".join(f"{k} {res[k]['f64_err']:.3e}"
                                  for k, _ in fe_kernels) + " (not gated)")
            del zr
            z = frames[fe_kernels[-1][0]]     # the frame the Scorer reads
            del frames

            ref = fused_block0_reference(z, block)
            top = ref.float().abs().max().item()
            shape = (b, 32, 23, (length - 128) // 9)
            b0_kernels = ([("fused_block0", fused_block0_mma),
                           ("block0_pipe", bp.block0_pipe)] if bf16
                          else [("fused_block0", fused_block0_fma),
                                ("block0_tf32x3", b32.block0_tf32x3)])
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
                if not bf16:
                    res[kname]["f64_err"] = f64_err(
                        out, fused_block0_reference, z, block)
            if not bf16:
                print(f"[kernel] {tag}: max|kernel - float64 plain| over "
                      "the first 16 rows: " + ", ".join(
                          f"{k} {res[k]['f64_err']:.3e}"
                          for k, _ in b0_kernels) + " (not gated)")
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
                bounds_z = frontend_bound(b, length, 70, dname, padded=True,
                                          all_bounds=True)
                runs = {k: [] for k, _ in fe_kernels}
                for kname, fn in fe_kernels + fe_kernels[::-1]:
                    runs[kname].append(
                        cuda_ms(lambda: fn(x, bank, bn_p, bn_s), 20))
                for kname, _ in fe_kernels:
                    ms = float(np.mean(runs[kname]))
                    res[kname].update(ms=ms, plain_ms=plain_z,
                                      library_ms=lib_z,
                                      **bound_fields(bounds_z, ms))
                    print(f"[kernel] {kname} {tag}: kernel {ms:.4f} ms (runs "
                          f"{[round(v, 4) for v in runs[kname]]}), plain "
                          f"{plain_z:.4f} ms, cuDNN chain {lib_z:.4f} ms, "
                          f"{bound_text(bounds_z, ms)}  [{card}]")
                plain_b = cuda_ms(lambda: fused_block0_reference(z, block), 5)
                bounds_b = block0_bound(b, length, 32, dname, all_bounds=True)
                runs = {k: [] for k, _ in b0_kernels}
                for kname, fn in b0_kernels + b0_kernels[::-1]:
                    runs[kname].append(cuda_ms(lambda: fn(z, block), 10))
                for kname, _ in b0_kernels:
                    ms = float(np.mean(runs[kname]))
                    res[kname].update(ms=ms, plain_ms=plain_b,
                                      library_ms=plain_b,
                                      **bound_fields(bounds_b, ms))
                    print(f"[kernel] {kname} {tag}: kernel {ms:.4f} ms (runs "
                          f"{[round(v, 4) for v in runs[kname]]}), plain (= "
                          f"the cuDNN chain) {plain_b:.4f} ms, "
                          f"{bound_text(bounds_b, ms)}  [{card}]")
                if not bf16:
                    # each new kernel beside the one it replaces, timed in
                    # the same turns
                    for new, old in (("fused_frontend_padded_tf32x3",
                                      "fused_frontend_padded"),
                                     ("fused_frontend_padded_ffma",
                                      "fused_frontend_padded"),
                                     ("block0_tf32x3", "fused_block0")):
                        res[new]["replaced_ms"] = res[old]["ms"]
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
    # and block0_tf32x3's bands of 8 rows: F = 30 and 47 are four and six
    # bands, the last one short, in f32
    block = copy.deepcopy(model32.encoder[0]).to("cuda")
    with torch.inference_mode():
        for b, f, t in [(2, 30, 300), (3, 47, 1001)]:
            z = torch.zeros((b, f + 2, t + 2), device="cuda")
            z[:, 1:-1, 1:-1] = torch.randn((b, f, t), generator=gen,
                                           device="cuda")
            ref = fused_block0_reference(z, block)
            top = ref.abs().max().item()
            out = b32.block0_tf32x3(z, block)
            torch.cuda.synchronize()
            rel = (out - ref).abs().max().item() / top
            print(f"[kernel] block0_tf32x3 float32 frame F={f} T_z={t} "
                  f"B={b}: max|kernel-plain| / max|plain| = {rel:.3e} (gate "
                  f"{TOL_BLOCK0['float32']})")
            check(tuple(out.shape) == (b, 32, f, t // 3)
                  and rel <= TOL_BLOCK0["float32"],
                  f"block0_tf32x3 disagrees with its plain version, F={f}")
    del block, z, ref, outs, out

    # the frontend on the tensor cores, in its two probe layouts (bf16
    # only): the wgmma kernel (csrc/frontend_dot_wg.cu) and the older one
    # (csrc/frontend_dot.cu), each under the same gates at every shape, the
    # new against the older within a bf16 ulp, and at B = 128 both timed in
    # turns (new, older, older, new).  Then a reading, no route: the new
    # source's plain and padded stores, gated as the routes' kernels are
    # and timed in turns with them (route, new, new, route)
    dots = {"fused_frontend_dot_fm": (fused_frontend_dot_fm,
                                      fused_frontend_dot_fm_reference, 0),
            "fused_frontend_dot_bm": (fused_frontend_dot_bm,
                                      fused_frontend_dot_bm_reference, 1),
            "fused_frontend_dot_fm_older": (fused_frontend_dot_fm_older,
                                            fused_frontend_dot_fm_reference,
                                            0),
            "fused_frontend_dot_bm_older": (fused_frontend_dot_bm_older,
                                            fused_frontend_dot_bm_reference,
                                            1)}
    readings = {"fused_frontend_dot_plain": (
                    "plain", fused_frontend_dot_plain,
                    fused_frontend_reference),
                "fused_frontend_dot_padded": (
                    "padded", fused_frontend_dot_padded,
                    fused_frontend_dot_padded_reference)}
    dot_results = {}
    wg_readings = {}                   # the new source's plain / padded
    for b, length, masked in [(128, 64600, False), (256, 64600, False),
                              (3, 16001, True)]:
        tag = f"bfloat16 B={b} L={length}{' masked' if masked else ''}"
        x = (torch.randn((b, length), generator=gen, device="cuda")
             * 0.1).bfloat16()
        bank = model32.filterbank.detach().to("cuda", torch.bfloat16).clone()
        if masked:
            bank[10:20] = 0
        bn_p, bn_s = bn_dicts(torch.bfloat16)
        args = (x, bank, bn_p, bn_s)
        t_out = (length - 128) // 3
        v1 = fused_frontend_fma(*args)[:, 0]
        outs = {}
        for name, (fn, ref_fn, row_axis) in dots.items():
            got = fn(*args)
            torch.cuda.synchronize()
            ref = ref_fn(*args)
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
            outs[name] = got
            if b == 128:
                dot_results[name] = dict(max_abs_err=err)
            del ref, rows
        for new in ("fused_frontend_dot_fm", "fused_frontend_dot_bm"):
            over, differ, top = ulp_excess(outs[new], outs[new + "_older"])
            print(f"[kernel] {new} {tag}: against {new}_older, {differ} of "
                  f"{outs[new].numel()} elements differ, {over} by more "
                  f"than a bf16 ulp and {DOT_NEAR_ZERO} of max|older| "
                  f"(max|new - older| {top:.3e})")
            check(over == 0, f"{new} is more than a bf16 ulp from "
                  f"{new}_older, {tag}")
            if b == 128:
                dot_results[new]["vs_older"] = dict(
                    differ=differ, max_abs_diff=top)
        del outs
        for name, (layout, route, ref_fn) in readings.items():
            wg = lambda: fv._launch(f"{fv.SOURCE} {layout}", *args, layout,
                                    fv.SOURCE)
            got = wg()
            torch.cuda.synchronize()
            ref = ref_fn(*args)
            check(got.shape == ref.shape and got.dtype == torch.bfloat16
                  and bool(torch.isfinite(got).all()),
                  f"{fv.SOURCE} {layout}: output {tuple(got.shape)}, want "
                  f"{tuple(ref.shape)}, finite")
            err = (got.float() - ref.float()).abs().max().item()
            check(torch.allclose(got.float(), ref.float(), **TOL_BF16_KERNEL),
                  f"{fv.SOURCE}'s {layout} store disagrees with its plain "
                  f"version, {tag}")
            if layout == "padded":
                border = (torch.cat([got[:, 0], got[:, -1]], 1).abs().max()
                          + torch.cat([got[:, :, 0], got[:, :, -1]], 1)
                          .abs().max()).item()
                check(border == 0, f"{fv.SOURCE} padded border not zero, "
                      f"{tag}")
            over, differ, top = ulp_excess(got, route(*args))
            print(f"[reading] {fv.SOURCE} {layout} store {tag}: "
                  f"max|kernel-plain| = {err:.3e}; against {name}, {differ} "
                  f"elements differ, {over} beyond a bf16 ulp (max "
                  f"{top:.3e}; not a route)")
            check(over == 0, f"{fv.SOURCE}'s {layout} store is more than a "
                  f"bf16 ulp from {name}, {tag}")
            del got, ref
            if b == 128:
                runs = {"route": [], "wg": []}
                for k in ("route", "wg", "wg", "route"):
                    runs[k].append(cuda_ms(
                        wg if k == "wg" else lambda: route(*args), 20))
                ms, route_ms = (float(np.mean(runs[k]))
                                for k in ("wg", "route"))
                wg_readings[name] = dict(
                    source=f"aasist_tpu_torch/csrc/{fv.SOURCE}.cu",
                    max_abs_err=err, ms=ms, route_ms=route_ms,
                    runs=runs["wg"], route_runs=runs["route"])
                print(f"[reading] {fv.SOURCE} {layout} store {tag}: "
                      f"{ms:.4f} ms (runs {[round(v, 4) for v in runs['wg']]}"
                      f"), {name} in the same turns {route_ms:.4f} ms (runs "
                      f"{[round(v, 4) for v in runs['route']]})  [{card}]")
        if b == 128:
            bound, by = frontend_bound(b, length, 70, "bfloat16", rows=24)
            for new in ("fused_frontend_dot_fm", "fused_frontend_dot_bm"):
                ref_fn, row_axis = dots[new][1:]
                plain = cuda_ms(lambda: ref_fn(*args), 10)

                def lib_fn():
                    h = F.pad(library_chain(*args)[:, 0], (0, 0, 0, 1))
                    return (h.permute(1, 0, 2).contiguous() if row_axis == 0
                            else h)
                libms = cuda_ms(lib_fn, 10)
                pair = (new, new + "_older")
                runs = {k: [] for k in pair}
                for k in pair + pair[::-1]:
                    runs[k].append(cuda_ms(lambda: dots[k][0](*args), 20))
                for k in pair:
                    ms = float(np.mean(runs[k]))
                    dot_results[k].update(
                        ms=ms, runs=runs[k], plain_ms=plain, library_ms=libms,
                        bound_ms=bound, bound_by=by, bound_share=bound / ms)
                    print(f"[kernel] {k} {tag}: kernel {ms:.4f} ms (runs "
                          f"{[round(v, 4) for v in runs[k]]}), plain "
                          f"{plain:.4f} ms, cuDNN chain {libms:.4f} ms, "
                          f"bound {bound:.4f} ms ({by}), the kernel at "
                          f"{100 * bound / ms:.1f} % of it  [{card}]")
                dot_results[new]["older_ms"] = dot_results[pair[1]]["ms"]
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

    # the new head (csrc/frontend_head_pipe.cu) and the older one, and in
    # bf16 the new source's builds with the same function (frame tiles half
    # and a quarter as wide), each under the same gates; the new and the
    # older head timed in turns
    head_results = {}                  # fused_frontend_head
    head_older_results = {}            # fused_frontend_head_older
    same_function = {k: v for k, v in probe_feb0_ablate.builds().items()
                     if k in ("half", "quarter")}
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
        heads = {"fused_frontend_head": fused_frontend_head,
                 "fused_frontend_head_older": fused_frontend_head_older}
        heads.update({
            f"fused_frontend_head {vname}":
                (lambda *a, d=d, src=src: fh.launch(*a, defines=d,
                                                    source=src))
            for vname, (src, d) in same_function.items()
            if dname == "bfloat16"})
        errs = {}
        with torch.inference_mode():
            ry1, rx0 = fused_frontend_head_reference(x, bank, bn_p, bn_s,
                                                     block)
            top = ry1.abs().max().float().item()
            for hname, fn in heads.items():
                y1, x0 = fn(x, bank, bn_p, bn_s, block)
                torch.cuda.synchronize()
                check(tuple(y1.shape) == (b, 32, 24, t_out)
                      and tuple(x0.shape) == (b, 24, t_out)
                      and y1.dtype == x0.dtype == dtype,
                      f"{hname} outputs {tuple(y1.shape)} {tuple(x0.shape)} "
                      f"{y1.dtype}")
                check(bool(torch.isfinite(y1).all())
                      and bool(torch.isfinite(x0).all()),
                      f"{hname} not finite")
                row_max = x0.abs().amax(dim=(0, 2)).float()
                check(row_max[23].item() == 0
                      and bool((row_max[:23] > 0).all()),
                      f"{hname} x0: row 23 and nothing else must be zero, "
                      f"{tag}")
                tol = TOL_F32 if dname == "float32" else TOL_BF16_KERNEL
                err_x0 = max_abs_diff(x0, rx0)
                err_y1 = max_abs_diff(y1, ry1)
                rel_y1 = err_y1 / top
                errs[hname] = (err_y1, rel_y1, err_x0)
                print(f"[kernel] {hname} {tag}: x0 max|kernel-plain| = "
                      f"{err_x0:.3e} (atol {tol['atol']}, rtol "
                      f"{tol['rtol']}), row 23 exactly 0; y1 max|kernel-"
                      f"plain| = {err_y1:.3e}, / max|plain| = {rel_y1:.3e} "
                      f"(gate {TOL_HEAD_Y1[dname]})")
                check(torch.allclose(x0.float(), rx0.float(), **tol),
                      f"{hname}'s x0 disagrees with its plain version, {tag}")
                check(rel_y1 <= TOL_HEAD_Y1[dname],
                      f"{hname}'s y1 disagrees with its plain version, {tag}")
                if dname == "bfloat16":
                    excess = head_y1_excess(y1, x0, block,
                                            **HEAD_Y1_OWN_X0_TOL)
                    print(f"[kernel] {hname} {tag}: y1 against the f32 head "
                          f"of its own x0, worst element over (atol "
                          f"{HEAD_Y1_OWN_X0_TOL['atol']}, rtol "
                          f"{HEAD_Y1_OWN_X0_TOL['rtol']:.3e}) = "
                          f"{excess:.3e} (gate 1)")
                    check(excess <= 1, f"{hname}'s y1 is not conv1 + bn2 + "
                          f"SELU of its x0 element by element, {tag}")
                del y1, x0
            if dname == "float32" and b == 128:
                # a control, not gated: the plain version with cuDNN's TF32
                # on (PyTorch's default for convolutions; phase 1 turns it
                # off) on 16 rows, against the TF32-off one and the kernel
                y1 = fused_frontend_head(x[:16], bank, bn_p, bn_s, block)[0]
                torch.backends.cudnn.allow_tf32 = True
                try:
                    ty1 = fused_frontend_head_reference(
                        x[:16], bank, bn_p, bn_s, block)[0]
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                top16 = ry1[:16].abs().max().float().item()
                print(f"[kernel] fused_frontend_head {tag}, 16 rows: the "
                      f"plain version with cuDNN's TF32 on, y1 / max|plain| "
                      f"against TF32 off "
                      f"{max_abs_diff(ty1, ry1[:16]) / top16:.3e}, against "
                      f"the kernel {max_abs_diff(ty1, y1) / top16:.3e} "
                      f"(the kernel against TF32 off "
                      f"{max_abs_diff(y1, ry1[:16]) / top16:.3e}; not "
                      f"gated: TF32 stays off for the gates)")
                del y1, ty1
            del ry1, rx0
            if b == 128:
                runs = two_runs(
                    {hname: (lambda fn=fn: fn(x, bank, bn_p, bn_s, block))
                     for hname, fn in heads.items()}, 10)
                plain = cuda_ms(lambda: fused_frontend_head_reference(
                    x, bank, bn_p, bn_s, block), 5)
                libms = cuda_ms(lambda: head_library_chain(
                    x, bank, bn_p, bn_s, block), 5)
                bound, by = head_bound(b, length, 70, dname)
                ms = {hname: sum(r) / 2 for hname, r in runs.items()}
                for hname, store in (
                        ("fused_frontend_head", head_results),
                        ("fused_frontend_head_older", head_older_results)):
                    err_y1, rel_y1, err_x0 = errs[hname]
                    store[dname] = dict(
                        max_abs_err=err_y1, max_rel_err=rel_y1,
                        x0_max_abs_err=err_x0, ms=ms[hname],
                        runs=runs[hname], plain_ms=plain, library_ms=libms,
                        bound_ms=bound, bound_by=by)
                head_results[dname]["older_ms"] = \
                    ms["fused_frontend_head_older"]
                head_results[dname]["builds_ms"] = {
                    hname.split()[-1]: v for hname, v in ms.items()
                    if " " in hname}
                print(f"[kernel] fused_frontend_head {tag}: "
                      + ", ".join(f"{hname} {v:.4f} ms (runs "
                                  f"{runs[hname][0]:.4f}, "
                                  f"{runs[hname][1]:.4f})"
                                  for hname, v in ms.items())
                      + f" in turns, plain {plain:.4f} ms, cuDNN chain "
                      f"{libms:.4f} ms, bound {bound:.4f} ms ({by})  "
                      f"[{card}]")
        del x, block
        torch.cuda.empty_cache()

    # the block-0 variants (bf16 only): every construct set, stage and
    # cast-ladder variant against its plain version, on block0_pipe.cu and
    # on the older kernel, each pair timed in turns; then the cuts of both
    # in turns
    families = {
        "fused_block0_constructs": (
            bv.fused_block0_constructs, bv.fused_block0_constructs_older,
            bv.fused_block0_constructs_reference, construct_sets),
        "fused_block0_stage": (
            bv.fused_block0_stage, bv.fused_block0_stage_older,
            bv.fused_block0_stage_reference,
            {st: (st,) for st in bv.STAGES}),
        "fused_block0_epi": (
            bv.fused_block0_epi, bv.fused_block0_epi_older,
            bv.fused_block0_epi_reference,
            {v: (v,) for v in bv.EPI_VARIANTS})}
    variant_results = {name: {} for fam, (_, older, _, _) in families.items()
                       for name in ((fam, fam + "_older") if older
                                    else (fam,))}
    def stage_dma_chain(z):
        # stage dma as stock calls: the strided frame columns, channel 0,
        # the other 31 channels zero (bf16 throughout: exact)
        f_, t_ = z.shape[1] - 2, (z.shape[2] - 2) // 3
        col = F.pad(z, (5, 0))[:, None, :f_, 0:3 * t_:3]
        return F.pad(col, (0, 0, 0, 0, 0, 31))

    def stage_fill_chain(z):
        # stage fill as one cuDNN convolution with a ones kernel (bf16 in,
        # f32 sums), channel-padded
        f_, t_ = z.shape[1] - 2, (z.shape[2] - 2) // 3
        ones = z.new_ones((1, 1, 2, 9))
        y = F.conv2d(F.pad(z, (5, 0))[:, None], ones, stride=(1, 3))
        return F.pad(y[:, :, :f_, :t_], (0, 0, 0, 0, 0, 31))

    def stage_conv1_chain(block):
        # stage conv1 as one cuDNN convolution: the sum over a pooled
        # column's three times of conv1 (2x3, bn2 folded) and the downsample
        # (1x3 on the second row) is one (2,5) kernel at stride (1,3), the
        # shift and both biases three times; built here, outside the timing
        prm = fold_block0(block)
        c = prm.w1.shape[0]
        k = prm.w1.new_zeros((c, 1, 2, 5))
        for q in range(3):
            k[:, 0, :, q:q + 3] += prm.w1.reshape(c, 2, 3)
            k[:, 0, 1, q:q + 3] += prm.wd
        bias = 3 * (prm.shift1 + bv.variant_bias(block)[1])
        k, bias = k.bfloat16(), bias.bfloat16()

        def chain(z):
            f_, t_ = z.shape[1] - 2, (z.shape[2] - 2) // 3
            y = F.conv2d(F.pad(z, (3, 0))[:, None], k, bias, stride=(1, 3))
            return y[:, :, :f_, :t_]
        return chain

    # vname: block -> the stage's stock chain, a function of the frame
    stage_library = {"dma": lambda block: stage_dma_chain,
                     "fill": lambda block: stage_fill_chain,
                     "conv1": stage_conv1_chain}
    cut_results = {}                   # cut: {"ms", "older_ms", their runs}
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
            if b == 128:
                # the timing cuts (no defined output), both kernels in turns
                runs = two_runs(
                    {f"{c}{tag_}": (lambda c=c, fn=fn: fn(z, block, c))
                     for c in bv.CUTS
                     for tag_, fn in (("", bv.fused_block0_cut),
                                      (" older", bv.fused_block0_cut_older))},
                    5)
                for c in bv.CUTS:
                    cut_results[c] = {
                        "ms": sum(runs[c]) / 2, "runs": runs[c],
                        "older_ms": sum(runs[c + " older"]) / 2,
                        "older_runs": runs[c + " older"]}
                print(f"[kernel] fused_block0_cut {tag}: "
                      + ", ".join(f"{c} {v['ms']:.4f} ms (older "
                                  f"{v['older_ms']:.4f})"
                                  for c, v in cut_results.items())
                      + f" in turns  [{card}]")
            for fam, (fn, older, ref_fn, cases_) in families.items():
                builds = {fam: fn}
                if older:
                    builds[fam + "_older"] = older
                for vname, vargs in cases_.items():
                    plain = ref_fn(z, block, *vargs)
                    errs = {}
                    for name, bfn in builds.items():
                        got = bfn(z, block, *vargs)
                        torch.cuda.synchronize()
                        check(tuple(got.shape) == shape
                              and got.dtype == torch.bfloat16
                              and bool(torch.isfinite(got).all()),
                              f"{name} {vname}: output {tuple(got.shape)} "
                              f"{got.dtype}, or not finite")
                        errs[name] = (got.float() - plain.float()).abs() \
                            .max().item()
                        fault = b0_fault(vname, z, block)
                        bad = fault and bfn(*fault, *vargs)
                        text, fails = b0_readings(
                            vname, got, plain, bad,
                            plain_base if vname in B0_BF16_EPILOGUES
                            else None)
                        print(f"[kernel] {name} {vname} {tag}: max|kernel-"
                              f"plain| = {errs[name]:.3e}, {text}")
                        check(not fails, f"{name}, {tag}: " + "; ".join(fails))
                        del got, bad, fault
                    if b == 128:
                        runs = two_runs(
                            {name: (lambda f=bfn: f(z, block, *vargs))
                             for name, bfn in builds.items()}, 5)
                        plain_ms = cuda_ms(lambda: ref_fn(z, block, *vargs),
                                           1, warmup=0)
                        bound, by = (
                            stage_bound(vname, b, length, 32, "bfloat16")
                            if fam == "fused_block0_stage"
                            else block0_bound(b, length, 32, "bfloat16"))
                        top = plain.float().abs().max().item()
                        ms = {name: sum(r) / 2 for name, r in runs.items()}
                        for name in builds:
                            variant_results[name][vname] = dict(
                                max_abs_err=errs[name],
                                max_rel_err=errs[name] / top, ms=ms[name],
                                runs=runs[name], plain_ms=plain_ms,
                                bound_ms=bound, bound_by=by, library_ms=None)
                        if older:
                            variant_results[fam][vname]["older_ms"] = \
                                ms[fam + "_older"]
                        if vname in stage_library:
                            lib = stage_library[vname](block)
                            lib_ms = cuda_ms(lambda: lib(z), 10)
                            for name in builds:
                                variant_results[name][vname][
                                    "library_ms"] = lib_ms
                            print(f"[kernel] {fam} {vname} {tag}: the stock "
                                  f"chain {lib_ms:.4f} ms (max|chain - "
                                  f"plain| {max_abs_diff(lib(z), plain):.3e})")
                        print(f"[kernel] {fam} {vname} {tag}: kernel "
                              + ", ".join(f"{name} {v:.4f} ms"
                                          for name, v in ms.items())
                              + f" (in turns), plain {plain_ms:.4f} ms, "
                              f"bound {bound:.4f} ms ({by})  [{card}]")
                    del plain
            del plain_base
        del x, z, block
        torch.cuda.empty_cache()

    # the tail kernels: the pools are exact, SELU + layout within an ulp;
    # selu_to_nchw first at a T of each residue mod 8, its output filled
    # with NaN, and on bases off a 16-byte boundary
    for dname in ("bfloat16", "float32"):
        lines, fails = probe_tail_constructs.selu_edge_cases(
            dname, TOL_SELU_NCHW[dname])
        for line in lines:
            print(f"[kernel] selu_to_nchw edge {dname} {line}")
        check(not fails, "; ".join(fails))
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
        # SELU + NCHW: the new kernel (csrc/selu_nchw.cu, any T) and the
        # older builds (csrc/tail_constructs.cu: "vector" where T allows
        # it, "staged"), each gated; then, in turns, with the timing-only
        # SNC_CUT build (the layout change alone, an exact copy) and the
        # stock chain
        zc = rand(32, 24, b, t)
        plain = tc.selu_to_nchw_reference(zc)
        tol = TOL_SELU_NCHW[dname]
        builds = {"selu_to_nchw": lambda: tc.selu_to_nchw(zc)}
        for how in (["vector"] if t % (16 // zc.element_size()) == 0
                    else []) + ["staged"]:
            builds[f"selu_to_nchw_older {how}"] = (
                lambda h=how: tc.selu_to_nchw_older(zc, h))
        errs = {}
        for label, fn in builds.items():
            got = fn()
            torch.cuda.synchronize()
            check(tuple(got.shape) == (b, 32, 24, t) and got.dtype == dtype
                  and got.is_contiguous(),
                  f"{label}: output {tuple(got.shape)} {got.dtype}")
            errs[label] = err = max_abs_diff(got, plain)
            print(f"[kernel] {label} {tag}: max|kernel-plain| = {err:.3e} "
                  f"(atol {tol['atol']}, rtol {tol['rtol']:.3e})")
            check(all(torch.allclose(g.float(), r.float(), **tol)
                      for g, r in zip(got.split(16), plain.split(16))),
                  f"{label} disagrees with its plain version, {tag}")
            del got
        if timed:
            check(torch.equal(tc.selu_to_nchw_cut(zc),
                              zc.permute(2, 0, 1, 3)),
                  f"selu_to_nchw's SNC_CUT build is no copy, {tag}")
            runs = two_runs({
                **builds, "cut": lambda: tc.selu_to_nchw_cut(zc),
                # the stock chain: F.selu in the working type, then the
                # NCHW copy
                "stock": lambda: F.selu(zc).permute(2, 0, 1, 3)
                .contiguous()}, 10)
            ms = {k: sum(r) / 2 for k, r in runs.items()}
            plain_ms = cuda_ms(lambda: tc.selu_to_nchw_reference(zc), 5)
            bound, by = bytes_bound(zc.numel(), zc.numel(), dname)
            for label in builds:
                tail_results[(label, dname, b)] = dict(
                    max_abs_err=errs[label], ms=ms[label], runs=runs[label],
                    plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=ms["stock"])
            tail_results[("selu_to_nchw", dname, b)].update(
                cut_ms=ms["cut"], older_ms={
                    label.rsplit(" ", 1)[1]: ms[label] for label in builds
                    if label != "selu_to_nchw"})
            print(f"[kernel] selu_to_nchw {tag} (in turns): "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f"; plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({by}); new at {100 * bound / ms['selu_to_nchw']:.1f} % "
                  f"of the bound  [{card}]")
        del plain
        del zc
        torch.cuda.empty_cache()

    # the step-cost kernel: every mode at block 0's grid geometry and at a
    # ragged one (g = 3, u = 104: a full 64-time sub-tile, then a 40-time
    # tail in which warps 5-7 hold no times; one TMA box of 104 times), the
    # output filled with NaN first, the TMA build and for its four modes
    # the older one; gates and planted faults in
    # tools/_common.py:stepcost_readings.  At block 0's geometry the builds
    # and the stock call are timed in turns.
    step_results = {"stepcost": {}, "stepcost_older": {}}
    step_fns = {"stepcost": sc.stepcost, "stepcost_older": sc.stepcost_older}
    for b, t, g, u in [(probe_stepcost.BATCH, probe_stepcost.T_TOTAL, 8, 256),
                       (6, 312, 3, 104)]:
        tag = f"B={b} T={t} (g, u) = ({g}, {u})"
        x, w = probe_stepcost.inputs(b, t, seed=1)
        full = b == probe_stepcost.BATCH
        lib_fns = probe_stepcost.library_calls(x, w) if full else {}
        with torch.inference_mode():
            for mode in sc.MODES:
                plain = sc.stepcost_reference(mode, x, w, g, u)
                builds = {name: fn for name, fn in step_fns.items()
                          if name == "stepcost" or mode in sc.TMA_MODES}
                errs = {}
                for name, fn in builds.items():
                    text, fails, errs[name] = probe_stepcost.check(
                        mode, x, w, g, u, True, plain, fn)
                    print(f"[kernel] {name} {mode} {tag}: {text}")
                    check(not fails, f"{name}, {tag}: " + "; ".join(fails))
                if not full:
                    continue
                runs = two_runs(
                    {**{name: (lambda fn=fn: fn(mode, x, w, g, u))
                        for name, fn in builds.items()},
                     "stock": lib_fns[mode]}, 10)
                ms = {name: sum(r) / 2 for name, r in runs.items()}
                plain_ms = cuda_ms(
                    lambda: sc.stepcost_reference(mode, x, w, g, u), 3)
                bound, by = stepcost_bound(mode, b, t)
                for name in builds:
                    step_results[name][mode] = dict(
                        max_abs_err=errs[name], ms=ms[name], runs=runs[name],
                        plain_ms=plain_ms, library_ms=ms["stock"],
                        library_runs=runs["stock"], bound_ms=bound,
                        bound_by=by, g=g, u=u)
                if "stepcost_older" in builds:
                    step_results["stepcost"][mode]["older_ms"] = \
                        ms["stepcost_older"]
                print(f"[kernel] stepcost {mode} {tag}: "
                      + ", ".join(f"{name} {v:.4f} ms (runs "
                                  f"{runs[name][0]:.4f}, {runs[name][1]:.4f})"
                                  for name, v in ms.items())
                      + f" in turns, plain {plain_ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({by})  [{card}]")
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

    # the chained-dot kernels at every dot shape: the wgmma kernel and the
    # older mma.sync one, each checked at a visible eps with its planted
    # fault (tools/_common.py:mma_readings), then timed a dot in turns at
    # the probe's eps
    mma_results = {"mma_chain": {}, "mma_chain_older": {}}
    with torch.inference_mode():
        for name in mm.SHAPES:
            errs = {}
            for label, fn in (("mma_chain", mm.mma_chain),
                              ("mma_chain_older", mm.mma_chain_older)):
                text, fails, errs[label] = probe_mxu_shapes.check(name, fn)
                print(f"[kernel] {label} {name}: {text}")
                check(not fails, f"{label}: " + "; ".join(fails))
            r = probe_mxu_shapes.measure(name, probe_mxu_shapes.N_DOTS, 5)
            common = dict(plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                          bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          n_dots=r["n_dots"])
            mma_results["mma_chain"][name] = dict(
                max_abs_err=errs["mma_chain"], ms=r["ms"], runs=r["runs"],
                launch_ms=r["launch_ms"], older_ms=r["older_ms"],
                cluster=r["cluster"], **common)
            mma_results["mma_chain_older"][name] = dict(
                max_abs_err=errs["mma_chain_older"], ms=r["older_ms"],
                runs=r["older_runs"], launch_ms=r["older_launch_ms"],
                **common)
            print(f"[kernel] mma_chain {name} (in turns): "
                  f"{1e3 * r['ms']:.3f} us a dot ({r['launch_ms']:.3f} ms a "
                  f"launch of {r['n_dots']}, cluster {r['cluster']}, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound), "
                  f"older {1e3 * r['older_ms']:.3f} us "
                  f"({r['older_launch_ms']:.3f} ms), plain "
                  f"{1e3 * r['plain_ms']:.3f} us, torch.mm "
                  f"{1e3 * r['library_ms']:.3f} us, bound "
                  f"{1e3 * r['bound_ms']:.3f} us ({r['bound_by']})  [{card}]")

    print(f"[kernel] phase 3: {time.perf_counter() - t3:.1f} s")

    # ---------------------------------------------------------------- 4
    # every kernel wrapper a Scorer path can reach (the routers in front of
    # them count nothing); all counts are set to 0 just before each run and
    # read just after it
    path_kernels = path_kernel_fns()

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

        def fused_stack(x, bank):
            z = fused_frontend_padded(
                x, bank, {"weight": bn.weight, "bias": bn.bias},
                {"mean": bn.running_mean, "var": bn.running_var})
            return fused_block0_mma(z, model.encoder[0])

        model.fused_stack = fused_stack

    def older_f32(on):
        """Route f32 to the older CUDA-core kernels (``on``) or back: the
        new wrappers' module names, which the routers read at each call,
        point at the kernels they replaced, so that these runs count the
        older kernels' launches and time the f32 paths as they were."""
        for name, mod, old in (
                (F32_FRONTEND, f32, fused_frontend_fma),
                ("fused_frontend_padded_tf32x3", f32,
                 fused_frontend_padded_fma),
                ("block0_tf32x3", b32, fused_block0_fma)):
            setattr(mod, name, old if on else path_kernels[name])

    walls = {}                         # serve()'s wall seconds by label

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
        walls[label] = wall
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
                                weights_path=weights, use_fused_stack=False)
    check(scorer.device.type == "cuda" and scorer.model.use_fused_frontend
          and not scorer.model.use_fused_stack,
          "Scorer(use_fused_stack=False) must run on CUDA with the fused "
          "frontend")
    check(scorer.batch_size == 128, f"batch size {scorer.batch_size}")
    scorer.warmup()
    rng = np.random.default_rng(0)
    requests = [[(rng.standard_normal(n) * 0.1).astype(np.float32)
                 for n in rng.integers(16000, 96001, size)]
                for size in (5, 131)]
    n_batches = sum(-(-len(r) // scorer.batch_size) for r in requests)

    scores, launches = serve(scorer, requests, {
        "fused_frontend_dot_plain": n_batches}, "bf16 frontend path")

    # the frontend + block-0 pair's path, the default, the same requests:
    # with the warp-specialised block 0, then with the older kernel
    stack = Scorer.from_config(ROOT / "configs" / "AASIST.conf",
                               weights_path=weights)
    check(stack.model.use_fused_stack,
          "the default bf16 Scorer must take the frontend + block-0 pair")
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
        F32_FRONTEND: n_batches}, "f32 frontend kernel")
    f32_stack_scores, f32_stack_launches = serve(s32_stack, requests, {
        "fused_frontend_padded_tf32x3": n_batches,
        "block0_tf32x3": n_batches}, "f32 stack")
    # the same f32 paths with the older CUDA-core kernels: their scores
    # within the f32 kernels' on/off gate of the new kernels' (the 3xTF32
    # ones sum f32-accurate products in another order)
    older_f32(True)
    f32_old_scores, f32_old_launches = serve(s32_on, requests, {
        "fused_frontend_fma": n_batches},
        "f32 frontend kernel, the older kernel")
    f32_stack_old_scores, f32_stack_old_launches = serve(
        s32_stack, requests, {"fused_frontend_padded_fma": n_batches,
                              "fused_block0_fma": n_batches},
        "f32 stack, the older kernels")
    older_f32(False)
    for tag, new_s, old_s in (("f32 kernel", f32_scores, f32_old_scores),
                              ("f32 stack", f32_stack_scores,
                               f32_stack_old_scores)):
        d = max(np.abs(np.asarray(a) - np.asarray(b)).max()
                for a, b in zip(new_s, old_s))
        print(f"[main] {tag} scores, new vs the older kernels: max|d| = "
              f"{d:.3e} (atol {TOL_MODEL_ON_OFF['atol']}, rtol "
              f"{TOL_MODEL_ON_OFF['rtol']})")
        check(all(np.allclose(a, b, **TOL_MODEL_ON_OFF)
                  for a, b in zip(new_s, old_s)),
              f"{tag}: the new and the older kernels' scores disagree")
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
    # the f32 paths' device forward at batch 128, the new kernels
    # against the older ones in turns (new, old, old, new)
    xb32 = torch.from_numpy(np.stack([pad_to_fixed(w)
                                      for w in requests[1][:128]])).cuda()
    f32_fwd = {}
    for sc_, tag, new_run, old_run in (
            (s32_stack, "f32 stack", "f32 stack",
             "f32 stack, the older kernels"),
            (s32_on, "f32 frontend", "f32 frontend kernel",
             "f32 frontend kernel, the older kernel")):
        runs = {False: [], True: []}
        for old in (False, True, True, False):
            older_f32(old)
            with torch.inference_mode():
                runs[old].append(cuda_ms(lambda: sc_.model(xb32), 3,
                                         warmup=1))
        older_f32(False)
        f32_fwd[tag] = {"new_ms": float(np.mean(runs[False])),
                        "older_ms": float(np.mean(runs[True])),
                        "scorer_s": walls[new_run],
                        "scorer_older_s": walls[old_run]}
        print(f"[main] {tag} forward, batch 128: new kernels "
              f"{f32_fwd[tag]['new_ms']:.3f} ms, the older kernels "
              f"{f32_fwd[tag]['older_ms']:.3f} ms (runs, older: "
              f"{ {k: [round(v, 3) for v in r] for k, r in runs.items()} }); "
              f"the Scorer's {n_batches} batches above {walls[new_run]:.3f} "
              f"s against {walls[old_run]:.3f} s  [{card}]")
    del s32_on, s32_off, s32_stack, stack, xb32

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
    stages = profile_stages_phase(card, path_kernels, scorer.model, xb,
                                  fwd, set_mode)

    # ---------------------------------------------------------------- 6
    del scorer, xb
    torch.cuda.empty_cache()
    eval_launches = eval_pipeline(card, path_kernels,
                                  keep=("LA99", "LA77"))
    torch.cuda.empty_cache()
    tools = tools_phase(card, path_kernels, ROOT / "chiprun_out" / "eval")
    (ROOT / "chiprun_out" / "tools.json").write_text(json.dumps(
        {"card": card, "profile_stages": stages, **tools}, indent=1))
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 7
    probed = {"fused_frontend_dot_fm": fused_frontend_dot_fm,
              "fused_frontend_dot_bm": fused_frontend_dot_bm,
              "fused_frontend_dot_fm_older": fused_frontend_dot_fm_older,
              "fused_frontend_dot_bm_older": fused_frontend_dot_bm_older,
              "fused_frontend_head": fused_frontend_head,
              "fused_frontend_head_older": fused_frontend_head_older,
              "fused_block0_constructs": bv.fused_block0_constructs,
              "fused_block0_constructs_older":
                  bv.fused_block0_constructs_older,
              "fused_block0_stage": bv.fused_block0_stage,
              "fused_block0_stage_older": bv.fused_block0_stage_older,
              "fused_block0_cut": bv.fused_block0_cut,
              "fused_block0_cut_older": bv.fused_block0_cut_older,
              "fused_block0_epi": bv.fused_block0_epi,
              "fused_block0_epi_older": bv.fused_block0_epi_older,
              "pool3_time": tc.pool3_time,
              "pool3_time_major": tc.pool3_time_major,
              "selu_to_nchw": tc.selu_to_nchw,
              "selu_to_nchw_older": tc.selu_to_nchw_older,
              "stepcost": sc.stepcost,
              "stepcost_older": sc.stepcost_older,
              "mma_chain": mm.mma_chain,
              "mma_chain_older": mm.mma_chain_older}
    # each probe with the kernels it must launch; every count is set to 0
    # just before a probe and read just after it, and a kernel's launches
    # are the sum over the probes that run it
    dots = ("fused_frontend_dot_fm", "fused_frontend_dot_bm",
            "fused_frontend_dot_fm_older", "fused_frontend_dot_bm_older")
    probe_launches = dict.fromkeys(probed, 0)
    # probe_fe_fix checks and times the batch-major kernels, new and older,
    # and puts the new filter-major one in front of block 0
    for probe, own in ((probe_frontend_variants, dots),
                       (probe_fe_fix, ("fused_frontend_dot_fm",
                                       "fused_frontend_dot_bm",
                                       "fused_frontend_dot_bm_older")),
                       (probe_feb0_ablate, ("fused_frontend_head",
                                            "fused_frontend_head_older")),
                       (probe_b0_constructs,
                        ("fused_block0_constructs",
                         "fused_block0_constructs_older")),
                       (probe_b0_ablate, ("fused_block0_stage",
                                          "fused_block0_stage_older",
                                          "fused_block0_cut",
                                          "fused_block0_cut_older")),
                       (probe_b0_epi, ("fused_block0_epi",
                                       "fused_block0_epi_older")),
                       (probe_tail_constructs, ("pool3_time",
                                                "pool3_time_major",
                                                "selu_to_nchw",
                                                "selu_to_nchw_older")),
                       (probe_stepcost, ("stepcost", "stepcost_older")),
                       (probe_mxu_shapes, ("mma_chain", "mma_chain_older"))):
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

    # ---------------------------------------------------------------- 8
    t0 = time.perf_counter()
    zoo_launches, zoo_report = zoo_phase(
        card, path_kernels, requests, ROOT / "chiprun_out" / "eval" / "LA99")
    print(f"[zoo] phase 8: {time.perf_counter() - t0:.1f} s")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "zoo.json").write_text(json.dumps(
        {"card": card, "launches": zoo_launches, "report": zoo_report},
        indent=1))

    def zoo_runs(kernel):
        """``kernel``'s launches on the zoo's paths, by arch and run."""
        return {arch: {run: c[kernel] for run, c in runs.items()
                       if kernel in c}
                for arch, runs in zoo_launches.items()}

    # ---------------------------------------------------------------- 9
    from aasist_tpu_torch.tools import train_golden
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    readings = train_golden.run(
        ["lr", "rawnet2", "aasist", "aasist2", "rawgatst"], device="cuda")
    for label, d, where, gate in readings:
        check(d <= gate, f"train golden {label}: max|diff| {d:.3e} at "
              f"{where or '-'} over its gate {gate:g}")
    print(f"[train] the reference's train goldens in float64 on the card: "
          f"{len(readings)} readings within their gates, "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    step_readings = train_step_readings("cuda", card)
    torch.cuda.empty_cache()
    timing = train_step_timing(card)
    torch.cuda.empty_cache()
    train_report = train_entry_point(card, path_kernels, keep=True)
    print(f"[train] phase 9: {time.perf_counter() - t0:.1f} s")
    (ROOT / "chiprun_out" / "train.json").write_text(json.dumps(
        {"card": card, "goldens": readings, "one_step": step_readings,
         "timing": timing, "entry_point": train_report}, indent=1))

    def train_runs(kernel):
        """``kernel``'s launches in phase 9's training runs, by run."""
        return {run: train_report[run]["launches"].get(kernel, 0)
                for run in TRAIN_RUNS}

    # ---------------------------------------------------------------- 10
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    parallel_report, parallel_runs = parallel_phase(
        card, path_kernels, requests, weights)
    print(f"[parallel] phase 10: {time.perf_counter() - t0:.1f} s")
    (ROOT / "chiprun_out" / "parallel.json").write_text(json.dumps(
        {"card": card, "report": parallel_report,
         "launches": parallel_runs}, indent=1))

    # ---------------------------------------------------------------- 11
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
         "eval_launches": eval_launches["bf16_frontend"][
             "fused_frontend_dot_plain"],
         "zoo_launches": zoo_runs("fused_frontend_dot_plain"),
         **dot_plain_results["bfloat16"], "dtype": "bfloat16",
         "shape": [128, 64600], "path": "bf16 frontend",
         "wgmma_reading": wg_readings["fused_frontend_dot_plain"]},
        {"name": "fused_frontend_dot_padded", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/frontend_dot.cu",
         "replaces": "tools/fused_stack.py:180",
         "launches": stack_launches["fused_frontend_dot_padded"],
         "eval_launches": eval_launches["bf16_stack"][
             "fused_frontend_dot_padded"],
         **s16["fused_frontend_dot_padded"], "dtype": "bfloat16",
         "shape": [128, 64600], "path": "bf16 stack (default)",
         "wgmma_reading": wg_readings["fused_frontend_dot_padded"]},
        {"name": "block0_pipe", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/block0_pipe.cu",
         "replaces": "tools/fused_stack.py:250",
         "launches": stack_launches["block0_pipe"], **s16["block0_pipe"],
         "eval_launches": eval_launches["bf16_stack"]["block0_pipe"],
         "phases_ms": phases.get("block0_pipe"), "dtype": "bfloat16",
         "shape": [128, 64600], "path": "bf16 stack (default)"},
        {"name": "fused_frontend_ffma", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/frontend_ffma.cu",
         "replaces": "aasist_tpu/ops/fused_frontend.py:79",
         "launches": f32_launches["fused_frontend_ffma"],
         "eval_launches": eval_launches["f32_frontend"][
             "fused_frontend_ffma"],
         "zoo_launches": zoo_runs("fused_frontend_ffma"),
         **f32_new["fused_frontend_ffma"]["float32"],
         "dtype": "float32", "shape": [128, 64600],
         "path": "f32 frontend kernel",
         "forward_ms": f32_fwd["f32 frontend"]},
        # the two f32 redesigns on no path: the 3xTF32 plain store (it tips
        # LA99's node-order tie, so the f32 frontend path keeps the CUDA
        # cores) and the CUDA-core padded store (the 3xTF32 one is faster)
        {"name": "fused_frontend_tf32x3", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/frontend_f32.cu",
         "replaces": "aasist_tpu/ops/fused_frontend.py:79",
         "launches": f32_launches["fused_frontend_tf32x3"],
         **f32_new["fused_frontend_tf32x3"]["float32"],
         "dtype": "float32", "shape": [128, 64600], "path": None},
        {"name": "fused_frontend_padded_ffma", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/frontend_ffma.cu",
         "replaces": "tools/fused_stack.py:180",
         "launches": f32_stack_launches.get("fused_frontend_padded_ffma", 0),
         **s32["fused_frontend_padded_ffma"], "dtype": "float32",
         "shape": [128, 64600], "path": None},
        {"name": "fused_frontend_padded_tf32x3", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/frontend_f32.cu",
         "replaces": "tools/fused_stack.py:180",
         "launches": f32_stack_launches["fused_frontend_padded_tf32x3"],
         **s32["fused_frontend_padded_tf32x3"], "dtype": "float32",
         "shape": [128, 64600], "path": "f32 stack"},
        {"name": "block0_tf32x3", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/block0_f32.cu",
         "replaces": "tools/fused_stack.py:250",
         "launches": f32_stack_launches["block0_tf32x3"],
         **s32["block0_tf32x3"], "dtype": "float32", "shape": [128, 64600],
         "path": "f32 stack", "forward_ms": f32_fwd["f32 stack"]},
        # the CUDA-core kernels the f32 routes left, their launches from
        # the same f32 paths run with them (older_f32)
        {"name": "fused_frontend", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/fused_frontend.cu",
         "replaces": "aasist_tpu/ops/fused_frontend.py:79",
         "launches": f32_old_launches["fused_frontend_fma"],
         **results["bfloat16"], "dtype": "bfloat16", "shape": [128, 64600],
         "path": "f32 frontend kernel with the older kernel (chip_smoke.py)",
         "float32": results["float32"]},
        {"name": "fused_frontend_padded", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/fused_frontend.cu",
         "replaces": "tools/fused_stack.py:180",
         "launches": f32_stack_old_launches["fused_frontend_padded_fma"],
         **s16["fused_frontend_padded"], "dtype": "bfloat16",
         "shape": [128, 64600],
         "path": "f32 stack with the older kernels (chip_smoke.py)",
         "float32": s32["fused_frontend_padded"]},
        {"name": "fused_block0", "route": "cuda",
         "source": "aasist_tpu_torch/csrc/fused_block0.cu",
         "replaces": "tools/fused_stack.py:250",
         "launches": old_launches["fused_block0_mma"], **s16["fused_block0"],
         "phases_ms": phases.get("fused_block0"), "dtype": "bfloat16",
         "shape": [128, 64600],
         "path": "bf16 stack with the older block 0 (chip_smoke.py)",
         "float32": {**s32["fused_block0"], "launches":
                     f32_stack_old_launches["fused_block0_fma"]}},
    ]
    # the probe layouts: the wgmma kernel's wrappers and their _older twins
    # on csrc/frontend_dot.cu
    probes = {"fused_frontend_dot_fm": "tools/probe_frontend_variants.py:62",
              "fused_frontend_dot_bm": "tools/probe_fe_fix.py:43"}
    for name, where in probes.items():
        for wrapper, src in ((name, fv.SOURCE),
                             (name + "_older", fv.OLDER_SOURCE)):
            kernels.append({
                "name": wrapper, "route": "cuda",
                "source": f"aasist_tpu_torch/csrc/{src}.cu",
                "replaces": where, "launches": probe_launches[wrapper],
                **dot_results[wrapper], "dtype": "bfloat16",
                "shape": [128, 64600]})
    for name, src, results_ in (
            ("fused_frontend_head", "frontend_head_pipe", head_results),
            ("fused_frontend_head_older", "frontend_head",
             head_older_results)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aasist_tpu_torch/csrc/{src}.cu",
            "replaces": "tools/probe_feb0_ablate.py:69",
            "launches": probe_launches[name], **results_["bfloat16"],
            "dtype": "bfloat16", "shape": [128, 64600],
            "float32": results_["float32"]})
    # the block-0 variants: one entry per wrapper, its numbers those of the
    # variant named in "variant", every variant's under "variants"; the
    # wrappers on block0_pipe.cu, their _older ones on fused_block0.cu; the
    # cuts' times (no defined output) under the stage entries
    for fam, head, where in (
            ("fused_block0_constructs", "all",
             "tools/probe_b0_constructs.py:29"),
            ("fused_block0_constructs_older", "all",
             "tools/probe_b0_constructs.py:29"),
            ("fused_block0_stage", "conv2", "tools/probe_b0_ablate.py:32"),
            ("fused_block0_stage_older", "conv2",
             "tools/probe_b0_ablate.py:32"),
            ("fused_block0_epi", "vA", "tools/probe_b0_epi.py:41"),
            ("fused_block0_epi_older", "vA", "tools/probe_b0_epi.py:41")):
        older = fam.endswith("_older")
        entry = {
            "name": fam, "route": "cuda",
            "source": "aasist_tpu_torch/csrc/"
                      f"{'fused_block0' if older else 'block0_pipe'}.cu",
            "replaces": where, "launches": probe_launches[fam],
            **variant_results[fam][head], "variant": head,
            "dtype": "bfloat16", "shape": [128, 64600],
            "variants": variant_results[fam]}
        if fam.startswith("fused_block0_stage"):
            cut = "fused_block0_cut" + ("_older" if older else "")
            entry["cuts_ms"] = {
                c: v["older_ms" if older else "ms"]
                for c, v in cut_results.items()}
            entry["cuts_launches"] = probe_launches[cut]
        kernels.append(entry)
    for name, label, src, where, shape, real in (
            ("pool3_time", "pool3_time staged", "tail_constructs",
             "tools/probe_tail_constructs.py:58",
             [64, 32, 23, 4608], [128, 32, 23, 21489]),
            ("pool3_time_major", "pool3_time_major", "tail_constructs",
             "tools/probe_tail_constructs.py:68",
             [64, 32, 4608, 23], [128, 32, 21489, 23]),
            ("selu_to_nchw", "selu_to_nchw", "selu_nchw",
             "tools/probe_tail_constructs.py:111",
             [32, 24, 64, 4608], [32, 24, 128, 21489]),
            ("selu_to_nchw_older", "selu_to_nchw_older staged",
             "tail_constructs", "tools/probe_tail_constructs.py:111",
             [32, 24, 64, 4608], [32, 24, 128, 21489])):
        entry = {
            "name": name, "route": "cuda",
            "source": f"aasist_tpu_torch/csrc/{src}.cu",
            "replaces": where, "launches": probe_launches[name],
            **tail_results[(label, "bfloat16", 64)], "dtype": "bfloat16",
            "shape": shape, "float32": tail_results[(label, "float32", 64)],
            "block0_size": {"shape": real,
                            **tail_results[(label, "bfloat16", 128)]}}
        if name == "selu_to_nchw_older":
            entry["variant"] = "staged (any T)"
            entry["vector"] = {
                d: tail_results[("selu_to_nchw_older vector", d, 64)]
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
            ("stepcost", "nop", "stepcost", "tools/probe_stepcost.py:53",
             step_results["stepcost"]),
            ("stepcost_older", "nop", "stepcost",
             "tools/probe_stepcost.py:53", step_results["stepcost_older"]),
            ("mma_chain", "k128_m128", "mma_chain_wg",
             "tools/probe_mxu_shapes.py:50", mma_results["mma_chain"]),
            ("mma_chain_older", "k128_m128", "mma_shapes",
             "tools/probe_mxu_shapes.py:50",
             mma_results["mma_chain_older"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aasist_tpu_torch/csrc/{src}.cu", "replaces": where,
            "launches": probe_launches[name], **variants[head],
            "variant": head, "dtype": "bfloat16", "variants": variants})
    # every kernel's launches in phase 9's training runs, under the name of
    # the wrapper that counts them (the f32 frontend on the scoring
    # batches, nothing in the train steps)
    wrappers = {"fused_frontend": "fused_frontend_fma",
                "fused_frontend_padded": "fused_frontend_padded_fma",
                "fused_block0": "fused_block0_mma"}
    for entry in kernels:
        wrapper = wrappers.get(entry["name"], entry["name"])
        entry["train_launches"] = train_runs(wrapper)
        # phase 10's data-parallel runs (every rank's launches summed)
        entry["parallel_launches"] = {
            run: c[wrapper] for run, c in parallel_runs.items()
            if c.get(wrapper)}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[2:]) if sys.argv[1:2] == ["--worker"]
             else main())
