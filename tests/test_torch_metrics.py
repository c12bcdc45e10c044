"""The port's scoring engine and score-file writer against the reference
golden (``tests/goldens/metrics_golden.npz``) and the JAX package's copies,
on seeded scores."""

import os

import numpy as np
import pytest

from aasist_tpu.evaluation import metrics as jax_metrics
from aasist_tpu.evaluation import scorefile as jax_scorefile

from aasist_tpu_torch.evaluation import metrics, scorefile

TOL = dict(rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def golden(golden_dir):
    return np.load(os.path.join(golden_dir, "metrics_golden.npz"))


def test_det_curve_and_eer_match_the_golden(golden):
    frr, far, thr = metrics.compute_det_curve(golden["bona"], golden["spoof"])
    np.testing.assert_allclose(frr, golden["frr"], **TOL)
    np.testing.assert_allclose(far, golden["far"], **TOL)
    np.testing.assert_allclose(thr, golden["thresholds"], **TOL)
    eer, thr = metrics.compute_eer(golden["bona"], golden["spoof"])
    assert eer == pytest.approx(float(golden["eer_cm"]), abs=1e-12)
    assert thr == pytest.approx(float(golden["thr_cm"]), abs=1e-12)
    eer, thr = metrics.compute_eer(golden["tar"], golden["non"])
    assert eer == pytest.approx(float(golden["eer_asv"]), abs=1e-12)
    assert thr == pytest.approx(float(golden["thr_asv"]), abs=1e-12)


def test_asv_rates_and_tdcf_match_the_golden(golden):
    rates = metrics.obtain_asv_error_rates(
        golden["tar"], golden["non"], golden["spf"], float(golden["thr_asv"]))
    np.testing.assert_allclose(
        rates, [float(golden[k]) for k in ("pfa_asv", "pmiss_asv",
                                           "pmiss_spoof_asv")], **TOL)
    curve, _ = metrics.compute_tdcf(golden["bona"], golden["spoof"], *rates)
    np.testing.assert_allclose(curve, golden["tdcf_curve"], **TOL)
    assert float(curve[np.argmin(curve)]) == pytest.approx(
        float(golden["min_tdcf"]), abs=1e-12)


def _scores(seed, n_bona=60, n_spoof=140, ties=False):
    rng = np.random.default_rng(seed)
    bona = rng.normal(1.0, 1.0, n_bona)
    spoof = rng.normal(-1.0, 1.5, n_spoof)
    if ties:                 # quantised: many equal scores across classes
        bona, spoof = np.round(bona, 1), np.round(spoof, 1)
    return bona, spoof


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, False)])
def test_functions_match_the_jax_package(seed, ties):
    bona, spoof = _scores(seed, ties=ties)
    for got, want in zip(metrics.compute_det_curve(bona, spoof),
                         jax_metrics.compute_det_curve(bona, spoof)):
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(metrics.compute_eer(bona, spoof),
                               jax_metrics.compute_eer(bona, spoof), **TOL)
    tar, non = _scores(seed + 10)
    spf = np.random.default_rng(seed + 20).normal(0, 1.5, 90)
    thr = metrics.compute_eer(tar, non)[1]
    rates = metrics.obtain_asv_error_rates(tar, non, spf, thr)
    np.testing.assert_allclose(
        rates, jax_metrics.obtain_asv_error_rates(tar, non, spf, thr), **TOL)
    for got, want in zip(metrics.compute_tdcf(bona, spoof, *rates),
                         jax_metrics.compute_tdcf(bona, spoof, *rates)):
        np.testing.assert_allclose(got, want, **TOL)


def _write_corpus_files(tmp_path, seed):
    """A CM score file (through the JAX writer) and an ASV score file of
    seeded scores, every attack id present."""
    rng = np.random.default_rng(seed)
    ids, meta, scores = [], {}, []
    for i in range(120):
        spoof = i % 3 != 0
        src = f"A{7 + i % 13:02d}" if spoof else "-"
        utt = f"LA_E_{i:05d}"
        ids.append(utt)
        meta[utt] = (src, "spoof" if spoof else "bonafide")
        scores.append(float(rng.normal(-1.0 if spoof else 1.0, 1.0)))
    cm = tmp_path / "cm.txt"
    jax_scorefile.write_score_file(cm, ids, scores, meta)
    asv = tmp_path / "asv.txt"
    asv.write_text("".join(
        f"spk{i} {key} {rng.normal(mu, 1.0):.6f}\n" for i in range(100)
        for key, mu in (("target", 3.0), ("nontarget", -3.0),
                        ("spoof", 0.0))))
    return ids, scores, meta, cm, asv


@pytest.mark.parametrize("seed", [3, 4])
def test_calculate_tdcf_eer_matches_the_jax_package(tmp_path, seed):
    _, _, _, cm, asv = _write_corpus_files(tmp_path, seed)
    got = metrics.calculate_tdcf_eer(cm, asv, tmp_path / "port.txt",
                                     printout=False)
    want = jax_metrics.calculate_tdcf_eer(cm, asv, tmp_path / "jax.txt",
                                          printout=False)
    np.testing.assert_allclose(got, want, **TOL)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


def test_hard_decisions_and_nan_raise():
    with pytest.raises(metrics.ScoringError, match="hard decisions"):
        metrics.compute_tdcf(np.ones(10), np.zeros(10), 0.01, 0.01, 0.5)
    with pytest.raises(metrics.ScoringError, match="nan"):
        metrics.compute_tdcf(np.array([np.nan, 1.0, 2.0]),
                             np.array([0.0, -1.0]), 0.01, 0.01, 0.5)


def test_score_file_is_the_jax_packages(tmp_path):
    ids, scores, meta, cm, _ = _write_corpus_files(tmp_path, 5)
    scorefile.write_score_file(tmp_path / "port.txt", ids, scores, meta)
    assert (tmp_path / "port.txt").read_bytes() == cm.read_bytes()
    assert scorefile.read_score_file(cm) == \
        jax_scorefile.read_score_file(cm)
    with pytest.raises(KeyError, match="not present"):
        scorefile.write_score_file(tmp_path / "x.txt", ["nope"], [0.0], meta)
    with pytest.raises(ValueError, match="utt ids"):
        scorefile.write_score_file(tmp_path / "x.txt", ids, scores[1:], meta)
