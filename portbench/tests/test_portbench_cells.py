"""Whole runs of small cells on the CPU, in a checkout of their own made
of files and entries alone (``cells.py``): the harness's look for a card
is skipped, the rest of a run is driven.  A sound program comes out
``correct``; the same run with the timed path broken underneath comes out
not correct, once for each fault the cell can have; and a scoring cell's
control (the reference in fp8 in the program's place) fails the limits.
"""

import json

import numpy as np
import pytest
import torch

from portbench import run as entry
from portbench.lib import compare, spec
from portbench.lib.run import execute
from portbench.tests import cells as C

SEED = 2**31 + 101


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    torch.set_num_threads(2)
    return C.make_checkout(tmp_path_factory.mktemp("checkout"), [
        ("tiny-score", "tiny", C.config(), "shards", C.SCORE_LIMITS),
        ("tiny-verify", "tiny", C.config(), "requests", C.SCORE_LIMITS),
        ("tiny-train", "tiny", C.config(), "train", C.TRAIN_LIMITS)])


def _line(checkout, name, seconds=1.5, keep=False):
    cell = spec.load_cell(checkout, name)
    out = execute(cell, SEED, seconds, False, torch.device("cpu"),
                  keep=keep)
    return cell, out, entry.result(cell, out, False, {"platform": "cpu",
                                                      "count": 1})


@pytest.mark.parametrize("name,metric", [
    ("tiny-score", "score_utt_s"), ("tiny-verify", "score_p95_ms"),
    ("tiny-train", "train_utt_s")])
def test_a_sound_run_is_correct(checkout, name, metric):
    _, out, line = _line(checkout, name)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", metric}
    assert list(line)[-1] == "checks" and out.failed == 0
    assert json.loads(json.dumps(line)) == line


def _altered_drain(self, ticket):
    from aasist_tpu_torch.serving import Scorer
    scores = Scorer._sound_drain(self, ticket).copy()
    scores[0] += 0.5
    return scores


def _half_batch_dispatch(self, waves):
    from aasist_tpu_torch.serving import Scorer
    half = waves[:max(1, len(waves) // 2)]
    ticket = Scorer._sound_dispatch(self, half)
    return ticket._replace(n=len(waves), scores=np.resize(
        ticket.scores, len(waves)))


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
@pytest.mark.parametrize("name", ["tiny-score", "tiny-verify"])
def test_a_broken_scorer_is_not_correct(checkout, monkeypatch, name, fault):
    from aasist_tpu_torch.serving import Scorer
    if fault == "answer_altered":
        monkeypatch.setattr(Scorer, "_sound_drain", Scorer._drain,
                            raising=False)
        monkeypatch.setattr(Scorer, "_drain", _altered_drain)
    else:
        monkeypatch.setattr(Scorer, "_sound_dispatch", Scorer._dispatch,
                            raising=False)
        monkeypatch.setattr(Scorer, "_dispatch", _half_batch_dispatch)
    _, _, line = _line(checkout, name)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(checkout, monkeypatch, fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    else:
        from aasist_tpu_torch.train import losses
        sound = losses.weighted_cce

        def half(logits, labels, *a, **kw):
            h = logits.shape[0] // 2
            return sound(logits[:h], labels[:h], *a, **kw)
        monkeypatch.setattr(losses, "weighted_cce", half)
    _, _, line = _line(checkout, "tiny-train")
    assert not line["correct"], line["checks"]
    if fault == "state_unchanged":
        # no leaf moved: the median leaf reads about 1
        assert line["checks"]["update_gap"]["value"] > 0.9


def test_the_fp8_control_fails_the_limits(checkout):
    cell, out, line = _line(checkout, "tiny-score", keep=True)
    assert line["correct"]
    ref, kept = cell.reference, out.kept
    low = ref.score_rows(kept["P"], kept["rows"],
                         cell.config["model_config"], device="cpu",
                         block=4, q=ref.fp8)
    ok, checks = compare.judge(compare.score_readings(
        low, kept["reference"]), cell.limits)
    assert not ok, checks


@pytest.mark.chip
def test_the_tf32_control_fails_the_limits(checkout, card):
    """On the card: the training reference with TF32 on, in the program's
    place, against the same reference with it off, fails the train
    cell's limits (TF32 does not exist on the CPU)."""
    from portbench.lib import weights
    from portbench.reference import training as ref_train
    cell = spec.load_cell(checkout, "tiny-train")
    _, _, line = _line(checkout, "tiny-train")
    mc, tc = cell.config["model_config"], cell.config["train"]
    from portbench.lib import traffic
    ids, pcm, labels = traffic.make_corpus(cell.traffic, SEED, "cpu")
    data = list(ref_train.batches(pcm, ids, labels, SEED, 4, 16000, 3))
    P = weights.make(cell.reference, mc, SEED, card)
    args = (cell.reference, P, data, mc, tc, SEED, len(ids) // 4, card)
    sound = ref_train.follow(*args)
    low = ref_train.follow(*args, tf32_on=True)
    ok, checks = compare.judge(compare.train_readings(low, sound),
                               cell.limits)
    assert not ok, checks
