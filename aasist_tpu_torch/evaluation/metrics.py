"""ASVspoof scoring: DET curve, EER, tandem DCF (own copy of
``aasist_tpu/evaluation/metrics.py``).

Pure NumPy, numerically identical to the reference's ``evaluation.py``, so
EER / min t-DCF agree bit for bit on the same score files
(``tests/goldens/metrics_golden.npz``).  The t-DCF is the ASVspoof2019
constrained t-DCF: a fixed ASV operating point and the 2019 evaluation
plan's cost model.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# ASVspoof2019 evaluation-plan cost model (reference evaluation.py:11-23).
_PSPOOF = 0.05
ASVSPOOF2019_COST_MODEL: Dict[str, float] = {
    "Pspoof": _PSPOOF,
    "Ptar": (1 - _PSPOOF) * 0.99,
    "Pnon": (1 - _PSPOOF) * 0.01,
    "Cmiss_asv": 1.0,
    "Cfa_asv": 10.0,
    "Cmiss_cm": 1.0,
    "Cfa_cm": 10.0,
}

ATTACK_TYPES = tuple(f"A{i:02d}" for i in range(7, 20))


def compute_det_curve(
    target_scores: np.ndarray, nontarget_scores: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Detection error tradeoff curve.

    Returns (frr, far, thresholds), each of length N+1 where
    N = len(target_scores) + len(nontarget_scores).  Matches
    `evaluation.py:120-145` exactly (mergesort order, leading sentinel
    threshold at ``min_score - 0.001``).
    """
    target_scores = np.asarray(target_scores, dtype=np.float64)
    nontarget_scores = np.asarray(nontarget_scores, dtype=np.float64)
    n_scores = target_scores.size + nontarget_scores.size
    all_scores = np.concatenate((target_scores, nontarget_scores))
    labels = np.concatenate(
        (np.ones(target_scores.size), np.zeros(nontarget_scores.size)))

    # stable sort so equal scores keep (target-before-nontarget) order,
    # matching the reference's kind='mergesort'
    order = np.argsort(all_scores, kind="mergesort")
    labels = labels[order]

    tar_cum = np.cumsum(labels)
    non_cum = nontarget_scores.size - (np.arange(1, n_scores + 1) - tar_cum)

    frr = np.concatenate((np.atleast_1d(0.0), tar_cum / target_scores.size))
    far = np.concatenate(
        (np.atleast_1d(1.0), non_cum / nontarget_scores.size))
    thresholds = np.concatenate(
        (np.atleast_1d(all_scores[order[0]] - 0.001), all_scores[order]))
    return frr, far, thresholds


def compute_eer(
    target_scores: np.ndarray, nontarget_scores: np.ndarray
) -> Tuple[float, float]:
    """Equal error rate and its threshold (`evaluation.py:148-154`)."""
    frr, far, thresholds = compute_det_curve(target_scores, nontarget_scores)
    idx = int(np.argmin(np.abs(frr - far)))
    eer = float(np.mean((frr[idx], far[idx])))
    return eer, float(thresholds[idx])


def obtain_asv_error_rates(
    tar_asv: np.ndarray,
    non_asv: np.ndarray,
    spoof_asv: np.ndarray,
    asv_threshold: float,
) -> Tuple[float, float, Optional[float]]:
    """ASV operating-point error rates (`evaluation.py:105-117`)."""
    pfa_asv = float(np.sum(non_asv >= asv_threshold) / non_asv.size)
    pmiss_asv = float(np.sum(tar_asv < asv_threshold) / tar_asv.size)
    pmiss_spoof_asv = (
        None if spoof_asv.size == 0
        else float(np.sum(spoof_asv < asv_threshold) / spoof_asv.size))
    return pfa_asv, pmiss_asv, pmiss_spoof_asv


class ScoringError(ValueError):
    """Raised on invalid scoring inputs (reference used sys.exit)."""


def compute_tdcf(
    bonafide_score_cm: np.ndarray,
    spoof_score_cm: np.ndarray,
    pfa_asv: float,
    pmiss_asv: float,
    pmiss_spoof_asv: Optional[float],
    cost_model: Dict[str, float] = ASVSPOOF2019_COST_MODEL,
) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized tandem-DCF curve over all CM thresholds.

    Same math and sanity checks as `evaluation.py:157-329`, with
    ``ScoringError`` instead of ``sys.exit`` so callers/tests can handle
    failures.  Returns (tDCF_norm, CM_thresholds).
    """
    if (cost_model["Ptar"] < 0 or cost_model["Pnon"] < 0
            or cost_model["Pspoof"] < 0
            or abs(cost_model["Ptar"] + cost_model["Pnon"]
                   + cost_model["Pspoof"] - 1) > 1e-10):
        raise ScoringError("prior probabilities must be >=0 and sum to one")
    if pmiss_spoof_asv is None:
        raise ScoringError(
            "miss rate of spoof trials against the ASV system is required")

    combined = np.concatenate((bonafide_score_cm, spoof_score_cm))
    if np.isnan(combined).any() or np.isinf(combined).any():
        raise ScoringError("CM scores contain nan or inf")
    if np.unique(combined).size < 3:
        raise ScoringError("CM scores look like hard decisions, need soft scores")

    pmiss_cm, pfa_cm, cm_thresholds = compute_det_curve(
        bonafide_score_cm, spoof_score_cm)

    c1 = (cost_model["Ptar"]
          * (cost_model["Cmiss_cm"] - cost_model["Cmiss_asv"] * pmiss_asv)
          - cost_model["Pnon"] * cost_model["Cfa_asv"] * pfa_asv)
    c2 = cost_model["Cfa_cm"] * cost_model["Pspoof"] * (1 - pmiss_spoof_asv)
    if c1 < 0 or c2 < 0:
        raise ScoringError(
            "negative t-DCF weights; check the ASV error rates")

    tdcf = c1 * pmiss_cm + c2 * pfa_cm
    tdcf_norm = tdcf / np.minimum(c1, c2)
    return tdcf_norm, cm_thresholds


def calculate_tdcf_eer(
    cm_scores_file,
    asv_score_file,
    output_file=None,
    printout: bool = True,
) -> Tuple[float, float]:
    """End-to-end scoring from score files (`evaluation.py:7-103`).

    CM file lines: ``utt_id src key score``; ASV file lines:
    ``spk key score`` (whitespace separated, as shipped with ASVspoof2019).
    Returns ``(EER%, min t-DCF)``.
    """
    asv_data = np.genfromtxt(asv_score_file, dtype=str)
    asv_keys = asv_data[:, 1]
    asv_scores = asv_data[:, 2].astype(np.float64)

    # atleast_2d: a single-line score file parses to shape (4,), which
    # would crash the column slicing (--debug_subset with one utterance)
    cm_data = np.atleast_2d(np.genfromtxt(cm_scores_file, dtype=str))
    cm_sources = cm_data[:, 1]
    cm_keys = cm_data[:, 2]
    cm_scores = cm_data[:, 3].astype(np.float64)

    tar_asv = asv_scores[asv_keys == "target"]
    non_asv = asv_scores[asv_keys == "nontarget"]
    spoof_asv = asv_scores[asv_keys == "spoof"]

    bona_cm = cm_scores[cm_keys == "bonafide"]
    spoof_cm = cm_scores[cm_keys == "spoof"]

    eer_asv, asv_threshold = compute_eer(tar_asv, non_asv)
    eer_cm = compute_eer(bona_cm, spoof_cm)[0]

    breakdown: Dict[str, float] = {}
    if printout or output_file is not None:
        for attack in ATTACK_TYPES:
            sub = cm_scores[cm_sources == attack]
            breakdown[attack] = compute_eer(bona_cm, sub)[0] * 100

    pfa_asv, pmiss_asv, pmiss_spoof_asv = obtain_asv_error_rates(
        tar_asv, non_asv, spoof_asv, asv_threshold)

    tdcf_curve, _ = compute_tdcf(
        bona_cm, spoof_cm, pfa_asv, pmiss_asv, pmiss_spoof_asv)
    min_tdcf = float(tdcf_curve[int(np.argmin(tdcf_curve))])

    # the report file is written whenever a path is given, printed or not
    # (the reference always writes it)
    if output_file is not None:
        lines = ["\nCM SYSTEM",
                 "\tEER\t\t= {:8.9f} % "
                 "(Equal error rate for countermeasure)".format(eer_cm * 100),
                 "\nTANDEM",
                 "\tmin-tDCF\t\t= {:8.9f}".format(min_tdcf),
                 "\nBREAKDOWN CM SYSTEM"]
        for attack in ATTACK_TYPES:
            lines.append("\tEER {a}\t\t= {e:8.9f} % "
                         "(Equal error rate for {a})".format(
                             a=attack, e=breakdown[attack]))
        text = "\n".join(lines) + "\n"
        with open(output_file, "w") as f:
            f.write(text)
        if printout:
            print(text)

    return eer_cm * 100, min_tdcf
