"""The readers of the program's own spans (``lib/spans.py``,
``metrics/dispatch_ms.score.py``, ``dispatch_stall_ms.verify.py``,
``step_stall_ms.train.py``): hand-computed values on a hand-built
``Trace``, no reading from a trace without the spans, and a traced run of
small cells on the CPU in which each finds its spans."""

import types

import pytest
import torch

from portbench import run as entry
from portbench.lib import spans
from portbench.lib import trace as tr
from portbench.lib.run import execute
from portbench.lib.spec import load_cell, metric_reader
from portbench.tests import cells as C
from portbench.tests.cells import REPO

MS = 1_000_000
SEED = 2**31 + 202


def _trace(host):
    """Device busy over 0-10, 30-40 and 60-90 ms of a 100 ms window."""
    ops = [("k_a", 0, 10 * MS), ("Memcpy HtoD", 30 * MS, 40 * MS),
           ("k_b", 60 * MS, 80 * MS), ("k_c", 70 * MS, 90 * MS)]
    return tr.Trace(0, 100 * MS, ops, [(n, a * MS, b * MS)
                                       for n, a, b in host])


def _ctx(trace, **counts):
    return types.SimpleNamespace(trace=trace, counts=counts, host={})


@pytest.fixture(scope="module")
def cells():
    return {name: load_cell(REPO, name) for name in (
        "aasist-score-b128", "aasist-train-b24", "aasist-verify-small")}


def test_interval_arithmetic():
    t = _trace([("serving.dispatch", 50, 55), ("serving.dispatch", 5, 20),
                ("aten::add", 6, 7)])
    assert spans.named(t, "serving.dispatch") == [(5 * MS, 20 * MS),
                                                   (50 * MS, 55 * MS)]
    assert spans.idle(t) == [(10 * MS, 30 * MS), (40 * MS, 60 * MS),
                             (90 * MS, 100 * MS)]
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25), (28, 40)]) == 12
    assert spans.overlap_ns([], [(0, 1)]) == 0


def test_dispatch_ms_is_the_dispatch_less_its_acquire_and_forward(cells):
    """The host's own work a batch: the forward's enqueue, which a full
    launch queue blocks, and the wait for a slot are left out."""
    read = metric_reader(cells["aasist-score-b128"], "dispatch_ms.score")
    t = _trace([("portbench.call", 0, 100),
                ("serving.dispatch", 2, 12), ("serving.acquire", 2, 5),
                ("serving.fill", 5, 8), ("serving.send", 8, 9),
                ("serving.forward", 9, 12), ("aten::add", 10, 11),
                ("serving.dispatch", 40, 46), ("serving.acquire", 40, 41),
                ("serving.fill", 41, 44), ("serving.forward", 44, 46),
                ("serving.acquire", 70, 80),      # outside any dispatch
                ("serving.forward", 85, 90)])
    # (10 - 3 - 3) + (6 - 1 - 2) ms over two batches
    assert read(_ctx(t, batches=2)) == pytest.approx(3.5)


def test_dispatch_stall_counts_only_the_overlap(cells):
    """A gap that the span covers only in part counts that part: the idle
    10-30 ms overlaps the dispatch 25-35 for 5 ms, and the idle 40-60 the
    dispatch 55-65 for 5 ms; the dispatch 0-8 lies over device work."""
    read = metric_reader(cells["aasist-verify-small"],
                         "dispatch_stall_ms.verify")
    t = _trace([("serving.dispatch", 0, 8), ("serving.dispatch", 25, 35),
                ("serving.dispatch", 55, 65), ("serving.drain", 10, 30)])
    assert read(_ctx(t, requests=2)) == pytest.approx(5.0)


def test_step_stall_reads_the_train_step(cells):
    read = metric_reader(cells["aasist-train-b24"], "step_stall_ms.train")
    t = _trace([("portbench.step", 0, 100), ("train.step", 5, 45),
                ("train.zero_grad", 5, 12), ("train.step", 50, 100)])
    # idle 10-30 (20) and 40-45 (5) in the first, 50-60 and 90-100 (20)
    # in the second: 45 ms over 3 steps
    assert read(_ctx(t, steps=3)) == pytest.approx(15.0)


@pytest.mark.parametrize("cell,name", [
    ("aasist-score-b128", "dispatch_ms.score"),
    ("aasist-verify-small", "dispatch_stall_ms.verify"),
    ("aasist-train-b24", "step_stall_ms.train")])
def test_no_reading_without_the_programs_spans(cells, cell, name):
    """A program that records no span (the parent of these spans) gives
    no reading, and no error; nor does an untraced run."""
    read = metric_reader(cells[cell], name)
    counts = {"batches": 2, "requests": 2, "steps": 2}
    assert read(_ctx(_trace([("portbench.call", 0, 100)]), **counts)) \
        is None
    assert read(_ctx(None, **counts)) is None


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    torch.set_num_threads(2)
    return C.make_checkout(tmp_path_factory.mktemp("checkout"), [
        ("tiny-score", "tiny", C.config(), "shards", C.SCORE_LIMITS),
        ("tiny-verify", "tiny", C.config(), "requests", C.SCORE_LIMITS),
        ("tiny-train", "tiny", C.config(), "train", C.TRAIN_LIMITS)])


@pytest.mark.parametrize("name,metric", [
    ("tiny-score", "dispatch_ms.score"),
    ("tiny-verify", "dispatch_stall_ms.verify"),
    ("tiny-train", "step_stall_ms.train")])
def test_a_traced_run_reads_the_programs_spans(checkout, name, metric):
    """On the CPU the profiler sees no device, so the whole window is
    idle and each stall is its span's length: a positive reading."""
    cell = load_cell(checkout, name)
    out = execute(cell, SEED, 1.0, True, torch.device("cpu"))
    line = entry.result(cell, out, True, {"platform": "cpu", "count": 1})
    assert line["correct"], line["checks"]
    assert line["metrics"][metric]["value"] > 0
