"""The driver of the ``score`` traffic kind: calls into
``aasist_tpu_torch.serving.Scorer.score_waveforms``.

Set-up builds the model from the configuration, fills it with the
benchmark's weights, makes the Scorer with the configuration's serving
settings (its route is the Scorer's default), makes the mix's pool and
warms up the one shape every call uses (full batches of the window).  The
window then calls ``score_waveforms`` for each request of the mix, back to
back (closed loop) or when due (open loop), until ``seconds`` have
passed; a call that started runs to its end, and the window ends when the
last one returned.  Each request is timed from its call (open loop: from
when it was due) to its scores' return.

The check samples the window's scores from the seed, the longest
utterance among them always in, and scores the same utterances with the
plain reference, which crops or tiles them itself, in float32 with TF32
off, once the program's state is freed.
"""

from __future__ import annotations

import math
import sys
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import compare, traffic, weights
from portbench.lib import run as runlib
from portbench.lib import trace as tr


def build_program(cell, P: Dict[str, torch.Tensor], device):
    """The program's model filled with ``P`` and its Scorer."""
    from aasist_tpu_torch.serving import Scorer

    model = load_program_model(cell.config["model_config"], P)
    serve = cell.config["serve"]
    return Scorer(model, device=device, bf16=serve["dtype"] == "bfloat16",
                  batch_size=serve["batch_size"], window=serve["window"])


def load_program_model(mc, P: Dict[str, torch.Tensor]):
    from aasist_tpu_torch.registry import build_model

    model = build_model(mc)
    missing, unexpected = model.load_state_dict(P, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"the benchmark's weights and the program's model "
                       f"disagree: missing {missing[:8]}, unexpected "
                       f"{unexpected[:8]}")
    return model


def run(cell, seed: int, seconds: float, trace: bool, device, keep: bool
        ) -> "runlib.Outcome":
    mix, serve = cell.traffic, cell.config["serve"]
    mc, ref = cell.config["model_config"], cell.reference
    scorer = build_program(cell, weights.of_config(
        serve["weights"], ref, mc, seed, device, cell.root), device)
    pool = traffic.make_pool(mix, seed, device)
    scorer.score_waveforms(pool[:3 * serve["batch_size"]])   # warm-up
    scorer.score_waveforms(pool[:1])
    tr.synchronize()

    setup_s = tr.process_age_s()
    records: List = []
    latencies: List[float] = []
    attempted = failed = batches = 0
    late = 0.0                      # how late the open loop's calls ran
    with tr.window(trace) as prof:
        w0 = time.perf_counter()
        for req, due in zip(traffic.requests(mix, seed),
                            traffic.due_times(mix)):
            if due is None:
                if time.perf_counter() - w0 >= seconds:
                    break
            else:
                if due >= seconds:
                    break
                wait = w0 + due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            t0 = time.perf_counter()
            start = t0 if due is None else w0 + due
            late = max(late, t0 - start)
            attempted += len(req)
            batches += math.ceil(len(req) / scorer.batch_size)
            try:
                with tr.span("portbench.call"):
                    out = scorer.score_waveforms([pool[i] for i in req])
            except Exception:       # counted and reported; the run goes on
                failed += len(req)
                if failed == len(req):
                    traceback.print_exc(file=sys.stderr)
                latencies.append(math.inf)
                continue
            latencies.append(time.perf_counter() - start)
            records.append((req, np.asarray(out, np.float64)))
        elapsed = time.perf_counter() - w0
    tr.synchronize()
    memory = runlib.peak_memory(device)
    trace_ = tr.read(prof) if prof is not None else None
    del scorer, prof
    runlib.free(device)

    done = attempted - failed
    lat_ms = np.array(latencies) * 1e3
    end_to_end = {"setup_s": setup_s, "score_utt_s": done / elapsed,
                  "score_p95_ms": float(np.percentile(lat_ms, 95))
                  if len(lat_ms) else math.inf}
    counts = {"utterances": done, "requests": len(latencies),
              "batches": batches, "window_s": elapsed,
              "late_ms_max": 1e3 * late}

    readings, kept = {}, {}
    if records:
        idx = np.concatenate([r for r, _ in records])
        got = np.concatenate([s for _, s in records])
        rng = np.random.default_rng((seed, 5))
        pick = rng.choice(len(idx), min(mix["check_sample"], len(idx)),
                          replace=False)
        longest = int(np.argmax([len(pool[i]) for i in idx]))
        if longest not in pick:
            pick[0] = longest
        rows = np.stack([ref.crop_or_tile(pool[idx[j]], serve["window"])
                         for j in pick])
        P_ref = weights.of_config(serve["weights"], ref, mc, seed, device,
                                  cell.root)
        want = ref.score_rows(P_ref, rows, mc, device=device,
                              block=serve["batch_size"])
        readings = compare.score_readings(got[pick], want)
        if keep:
            kept = {"rows": rows, "program": got[pick], "reference": want,
                    "P": P_ref}
    return runlib.Outcome(end_to_end, counts, {}, readings, attempted,
                          failed, memory, trace_, kept)
