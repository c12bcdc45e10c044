"""Assert the published reference quality numbers on a real LA corpus
(counterpart of ``tools/verify_reference_parity.py``).

The reference's headline result is EER 0.83 % / min t-DCF 0.0275 on
ASVspoof2019-LA eval with the pretrained AASIST checkpoint.  This tool runs
the port's own eval pipeline (native FLAC decode, ``EvalBatcher``'s
fixed-window padding, the forward with the converted checkpoint in f32 with
TF32 off, the score-file writer, the metrics) and prints a one-line JSON
verdict.

Real corpus::

    python -m aasist_tpu_torch.tools.verify_reference_parity \\
        --database_path /path/to/LA/

asserts EER <= 0.84 % and min t-DCF <= 0.0276 (the published numbers plus
0.01 / 0.0001 of scoring-order headroom).

Without a corpus it dry-runs the same logic on the synthetic corpus of the
e2e golden (seed 77, 48 eval utterances in FLAC) and asserts agreement with
the torch reference's scores (``tests/goldens/e2e_differential_golden.npz``):
scores within 1e-4, the same ranking, EER and min t-DCF within 1e-10.
``--big`` does the same for the five architectures on the seed-99 corpus
(512 WAV utterances) against ``e2e_diff_big_{arch}.npz``, each at its
tolerance, a swap of two utterances whose reference scores lie within twice
it allowed; a row of ``tools/_common.py``'s node-order tie tables is held to
the golden or to its reading in the other order, and the reference metrics
to those of the scores it is held to.  ``--corpus DIR`` scores a synthetic
corpus already generated with the mode's seed and sizes instead of making
one (the utterances must be the golden's).

    python -m aasist_tpu_torch.tools.verify_reference_parity   # synthetic
    python -m aasist_tpu_torch.tools.verify_reference_parity --big [--arch A]

It runs on the card (``--device`` defaults to ``cuda``; without a card that
raises: pass ``--device cpu``).  Exit code 0 iff the verdict passes.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from aasist_tpu_torch.tools._common import (NODE_ORDER_TIES, ROOT,
                                            ZOO_NODE_ORDER_TIES, tool_device)

# the published numbers plus scoring-order headroom
EER_THRESHOLD = 0.84        # %
TDCF_THRESHOLD = 0.0276

GOLDENS = ROOT / "tests" / "goldens"
GOLDEN = GOLDENS / "e2e_differential_golden.npz"

# the corpora of the e2e goldens
CORPUS_SEED, N_TRAIN, N_DEV, N_EVAL = 77, 4, 4, 48
BIG_SEED, BIG_TRAIN, BIG_DEV, BIG_EVAL = 99, 2, 2, 512
SCORE_TOL = 1e-4
METRIC_TOL = 1e-10

# per arch (stock config, weight source, score tolerance); each model runs
# in f32 on its config's stock route, as the JAX tool's configs do (the
# flagship, AASIST, is the real mode's model).  RawNet2's score is a
# LogSoftmax output downstream of a 3-layer GRU(1024), the longest f32
# accumulation chain of the zoo, so its tolerance is one decade looser;
# AASIST2's Res2Net split convs and SE chains match its unit golden's 1e-3.
BIG_ARCHS = {
    "AASIST": ("AASIST", ("ckpt", "AASIST.npz"), 1e-4),
    "AASIST-L": ("AASIST-L", ("ckpt", "AASIST-L.npz"), 1e-4),
    "AASIST2": ("AASIST2", ("golden_sd", "aasist2_golden.npz"), 1e-3),
    "RawNet2": ("RawNet2_baseline", ("golden_sd", "rawnet2_golden.npz"),
                1e-3),
    "RawGATST": ("RawGATST_baseline", ("golden_sd", "rawgatst_golden.npz"),
                 5e-4),
}
FLAGSHIP = "AASIST"

# each architecture's rows of the seed-99 golden held by id
BIG_TIES = {"AASIST": NODE_ORDER_TIES["LA99"], **ZOO_NODE_ORDER_TIES}


def build_arch(arch: str):
    """The model of a BIG_ARCHS entry in f32 on the CPU: its stock config's
    (``aasist_tpu_torch/configs/``), its weights from ``checkpoints/`` or
    from the golden's reference state dict."""
    from aasist_tpu_torch.config import load_config
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.utils.torch_compat import fill_from_state_dict
    from aasist_tpu_torch.weights import load_npz

    conf, (kind, name), _tol = BIG_ARCHS[arch]
    model = build_model(load_config(conf).model_config)
    if kind == "ckpt":
        return load_npz(model, ROOT / "checkpoints" / name)
    data = np.load(GOLDENS / name)
    return fill_from_state_dict(model, {k[len("sd__"):]: data[k]
                                        for k in data.files
                                        if k.startswith("sd__")})


def _paths(la_root) -> Tuple[Path, Path]:
    la_root = Path(la_root)
    return (la_root / "ASVspoof2019_LA_cm_protocols"
            / "ASVspoof2019.LA.cm.eval.trl.txt",
            la_root / "ASVspoof2019_LA_asv_scores"
            / "ASVspoof2019.LA.asv.eval.gi.trl.scores.txt")


def score_corpus(la_root, batch_size: int, out_dir, model=None,
                 device="cuda"):
    """The port's eval pipeline over ``{la_root}/ASVspoof2019_LA_eval``
    with ``model`` (default: the pretrained flagship, ``configs/AASIST.conf``
    with ``checkpoints/AASIST.npz``) in f32 on ``device``, TF32 off:
    (utt_ids, scores as float64, EER %, min t-DCF).  The score file is
    ``{out_dir}/parity_scores.txt``."""
    from aasist_tpu_torch.cli import full_f32
    from aasist_tpu_torch.data.dataset import AudioStore, EvalBatcher
    from aasist_tpu_torch.data.protocol import parse_protocol, trial_metadata
    from aasist_tpu_torch.evaluation.metrics import calculate_tdcf_eer
    from aasist_tpu_torch.evaluation.scorefile import write_score_file
    from aasist_tpu_torch.train.loop import produce_scores

    proto, asv = _paths(la_root)
    entries = parse_protocol(proto)
    files = [e.utt_id for e in entries]
    if model is None:
        model = build_arch(FLAGSHIP)
    model = model.float().eval().to(device)
    batcher = EvalBatcher(
        AudioStore(Path(la_root) / "ASVspoof2019_LA_eval"), files,
        batch_size=batch_size)
    with full_f32():
        ids, scores = produce_scores(model, batcher)
    if ids != files:
        raise RuntimeError("the scores' utterances are not the protocol's")
    cm_path = Path(out_dir) / "parity_scores.txt"
    write_score_file(cm_path, ids, scores, trial_metadata(entries))
    eer, min_tdcf = calculate_tdcf_eer(cm_path, asv, printout=False)
    return ids, np.asarray(scores, np.float64), eer, min_tdcf


def real_verdict(eer: float, min_tdcf: float) -> dict:
    return {
        "mode": "real", "eer_pct": float(eer), "min_tdcf": float(min_tdcf),
        "eer_threshold": EER_THRESHOLD, "tdcf_threshold": TDCF_THRESHOLD,
        "pass": bool(eer <= EER_THRESHOLD and min_tdcf <= TDCF_THRESHOLD),
    }


def golden_verdict(ids, scores, eer: float, min_tdcf: float, golden,
                   tol: float, swap_tie: float,
                   ties: Optional[Dict[str, float]] = None,
                   rescore: Optional[Callable] = None) -> dict:
    """Scores against a golden (``utt_ids``, ``scores``, ``eer``,
    ``min_tdcf``): every score within ``tol``, the same ranking but for
    swaps of utterances whose reference scores lie within ``swap_tie``,
    EER and min t-DCF within 1e-10.  A row of ``ties`` (utt id -> its
    reading in the other node order) is held to the golden or to that
    reading, whichever is nearer; when it is held to the other reading,
    ``rescore(reference scores)`` gives the metrics of the held scores."""
    ids = [str(u) for u in ids]
    if ids != [str(u) for u in golden["utt_ids"]]:
        raise ValueError("the corpus's eval utterances are not the "
                         "golden's")
    scores = np.asarray(scores, np.float64)
    ref = np.asarray(golden["scores"], np.float64).copy()
    ref_eer, ref_tdcf = float(golden["eer"]), float(golden["min_tdcf"])
    held = {}
    for utt, other in (ties or {}).items():
        i = ids.index(utt)
        to_other = abs(scores[i] - other) < abs(scores[i] - ref[i])
        held[utt] = {"score": float(scores[i]), "golden": float(ref[i]),
                     "other_order": other,
                     "held_to": "other_order" if to_other else "golden"}
        if to_other:
            ref[i] = other
    if any(h["held_to"] == "other_order" for h in held.values()):
        ref_eer, ref_tdcf = rescore(ref)
    max_diff = float(np.max(np.abs(scores - ref)))
    order, ref_order = np.argsort(scores), np.argsort(ref)
    swaps = order != ref_order
    rank_ok = bool(np.all(np.abs(ref[order[swaps]] - ref[ref_order[swaps]])
                          < swap_tie))
    eer_ok = abs(eer - ref_eer) < METRIC_TOL
    tdcf_ok = abs(min_tdcf - ref_tdcf) < METRIC_TOL
    out = {"eer_pct": float(eer), "min_tdcf": float(min_tdcf),
           "golden_eer_pct": float(golden["eer"]),
           "golden_min_tdcf": float(golden["min_tdcf"]),
           "max_abs_score_diff": max_diff, "score_tol": tol,
           "rank_identical": rank_ok,
           "pass": bool(max_diff < tol and rank_ok and eer_ok and tdcf_ok)}
    if held:
        out["node_order_ties"] = held
        out["reference_eer_pct"] = float(ref_eer)
        out["reference_min_tdcf"] = float(ref_tdcf)
    return out


def _rescorer(la_root, ids, out_dir, name: str) -> Callable:
    """Reference scores -> their (EER %, min t-DCF), through a score file
    ``{out_dir}/{name}``."""
    from aasist_tpu_torch.data.protocol import parse_protocol, trial_metadata
    from aasist_tpu_torch.evaluation.metrics import calculate_tdcf_eer
    from aasist_tpu_torch.evaluation.scorefile import write_score_file

    proto, asv = _paths(la_root)

    def rescore(ref):
        path = Path(out_dir) / name
        write_score_file(path, ids, ref.tolist(),
                         trial_metadata(parse_protocol(proto)))
        return calculate_tdcf_eer(path, asv, printout=False)

    return rescore


def run_real(database_path, batch_size: int, out_dir, device="cuda"
             ) -> dict:
    _, _, eer, min_tdcf = score_corpus(database_path, batch_size, out_dir,
                                       device=device)
    return real_verdict(eer, min_tdcf)


def run_synthetic(batch_size: int, out_dir, device="cuda", corpus=None
                  ) -> dict:
    """The dry run on the seed-77 corpus (made under ``out_dir`` unless
    ``corpus`` names one) against the torch reference's golden."""
    from aasist_tpu_torch.data import synthetic

    root = Path(corpus) if corpus else Path(out_dir) / "LA"
    if corpus is None:
        synthetic.generate(root, n_train=N_TRAIN, n_dev=N_DEV,
                           n_eval=N_EVAL, seed=CORPUS_SEED)
    ids, scores, eer, min_tdcf = score_corpus(root, batch_size, out_dir,
                                              device=device)
    return {"mode": "synthetic",
            **golden_verdict(ids, scores, eer, min_tdcf, np.load(GOLDEN),
                             SCORE_TOL, swap_tie=0.0)}


def big_corpus(out_dir) -> Path:
    """The seed-99 corpus under ``out_dir/LA_big``, made once for all
    architectures behind its ``.complete`` marker: a partial corpus from an
    interrupted run is made again, never reused."""
    from aasist_tpu_torch.data import synthetic

    root = Path(out_dir) / "LA_big"
    if not (root / ".complete").exists():
        shutil.rmtree(root, ignore_errors=True)
        synthetic.generate(root, n_train=BIG_TRAIN, n_dev=BIG_DEV,
                           n_eval=BIG_EVAL, seed=BIG_SEED,
                           audio_format="wav")
        (root / ".complete").write_text("ok\n")
    return root


def run_synthetic_big(arch: str, batch_size: int, out_dir, device="cuda",
                      corpus=None) -> dict:
    """One architecture on the seed-99 corpus against
    ``e2e_diff_big_{arch}.npz``."""
    _conf, _src, tol = BIG_ARCHS[arch]
    golden = np.load(GOLDENS / f"e2e_diff_big_{arch}.npz")
    root = Path(corpus) if corpus else big_corpus(out_dir)
    ids, scores, eer, min_tdcf = score_corpus(
        root, batch_size, out_dir, model=build_arch(arch), device=device)
    verdict = golden_verdict(
        ids, scores, eer, min_tdcf, golden, tol, swap_tie=2 * tol,
        ties=BIG_TIES.get(arch),
        rescore=_rescorer(root, ids, out_dir, f"held_reference_{arch}.txt"))
    return {"mode": "synthetic_big", "arch": arch, "n_eval": len(ids),
            **verdict}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--database_path", default=None,
                    help="real ASVspoof2019 LA root (contains "
                         "ASVspoof2019_LA_eval/ etc.); omit for the "
                         "synthetic dry run")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--out_dir", default=None,
                    help="where to write the score files (default: tmp)")
    ap.add_argument("--big", action="store_true",
                    help="512-utterance per-arch differential over the "
                         "whole zoo (synthetic corpus)")
    ap.add_argument("--arch", default=None, choices=sorted(BIG_ARCHS),
                    help="with --big: restrict to one architecture")
    ap.add_argument("--corpus", default=None,
                    help="a synthetic corpus already made with the mode's "
                         "seed and sizes (default: make one under out_dir)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    device = tool_device("verify_reference_parity", args.device)
    out_dir = Path(args.out_dir or tempfile.mkdtemp(prefix="parity_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.database_path:
        verdict = run_real(args.database_path, args.batch_size, out_dir,
                           device)
    elif args.big:
        archs = [args.arch] if args.arch else sorted(BIG_ARCHS)
        per = {a: run_synthetic_big(a, args.batch_size, out_dir, device,
                                    args.corpus)
               for a in archs}
        verdict = {"mode": "synthetic_big", "archs": per,
                   "pass": all(v["pass"] for v in per.values())}
    else:
        verdict = run_synthetic(args.batch_size, out_dir, device,
                                args.corpus)
    if device.type == "cuda":
        import torch
        verdict["device"] = torch.cuda.get_device_name(device)
    else:
        verdict["device"] = str(device)
    print(json.dumps(verdict))
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
