"""The yardstick kept with the benchmark: the frontend's bound, the FLOP
counts the configurations store, the trace arithmetic and the readers."""

import json
import types

import pytest

from portbench.lib import flops, roofline
from portbench.lib import trace as tr
from portbench.lib.spec import load_cell, metric_reader
from portbench.tests.cells import HARNESS, REPO


def test_frontend_bound_is_row_1b():
    ms, what = roofline.frontend_bound(128, 64600, 70, "bfloat16")
    assert what == "operations" and round(ms, 4) == 0.1485


@pytest.mark.parametrize("config,key", [
    ("aasist", "forward@64600"), ("aasist", "train@96000"),
    ("aasist2", "forward@64600")])
def test_stored_flops_are_the_reference_count(config, key):
    conf = json.loads((HARNESS / "configs" / f"{config}.json").read_text())
    mode, length = key.split("@")
    want = flops.count(conf["model_config"], int(length), mode == "train")
    assert conf["flops"][key] == want
    if key == "forward@64600" and config == "aasist":
        assert abs(want / 1e9 - 19.12) < 0.01


def _trace():
    ms = 1_000_000
    ops = [("k_a", 0, 10 * ms), ("k_b", 5 * ms, 20 * ms),
           ("Memcpy HtoD", 30 * ms, 40 * ms), ("k_a", 60 * ms, 70 * ms),
           ("bn_fw_tr_1C11_kernel", 70 * ms, 75 * ms)]
    host = [("portbench.call", 0, 100 * ms), ("aten::conv2d", 40 * ms,
                                              65 * ms)]
    return tr.Trace(0, 100 * ms, ops, host)


def test_union_and_idle_share():
    t = _trace()
    assert t.busy_s() == pytest.approx(0.020 + 0.010 + 0.015)
    assert t.busy_s(t.kernels()) == pytest.approx(0.035)
    assert t.window_s == pytest.approx(0.1)
    assert tr.union([("x", 0, 5), ("y", 1, 3), ("z", 6, 9)]) == [
        (0, 5), (6, 9)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k_a", 0.02]
    gap, seconds = b["idle_gaps"][0]
    assert seconds == pytest.approx(0.025) and "portbench.call" in gap
    assert b["idle_gaps"][1][0] == "portbench.call > aten::conv2d"


@pytest.fixture(scope="module")
def cells():
    return {name: load_cell(REPO, name) for name in (
        "aasist-score-b128", "aasist-train-b24", "aasist-verify-small")}


def _ctx(cell, **counts):
    from portbench.lib import roofline
    return types.SimpleNamespace(
        config=cell.config, traffic=cell.traffic, trace=_trace(),
        counts=counts, host={"loader_wait_ms": 1.5}, roofline=roofline)


def test_readers_read_the_trace(cells):
    score = _ctx(cells["aasist-score-b128"], batches=2, utterances=256)
    read = lambda c, n: metric_reader(c, n)  # noqa: E731
    s = cells["aasist-score-b128"]
    assert read(s, "forward_ms.score")(score) == pytest.approx(17.5)
    assert read(s, "idle_share.score")(score) == pytest.approx(0.55)
    assert read(s, "mfu.score")(score) == pytest.approx(
        100 * 19124381856 * 256 / 0.1 / 989e12)
    # no frontend kernel in the trace: no reading, never 0
    assert read(s, "frontend_roofline")(score) is None
    t = cells["aasist-train-b24"]
    train = _ctx(t, steps=5, rows=120)
    assert read(t, "bn_ms.train")(train) == pytest.approx(1.0)
    assert read(t, "loader_wait_ms.train")(train) == 1.5
    assert read(t, "mfu.train")(train) == pytest.approx(
        100 * 81877848768 * 120 / 0.1 / 67e12)
    v = cells["aasist-verify-small"]
    assert read(v, "forward_ms.verify")(_ctx(v, requests=5)) == \
        pytest.approx(7.0)


def test_frontend_roofline_reads_the_kernel(cells):
    s = cells["aasist-score-b128"]
    ctx = _ctx(s, batches=1)
    ctx.trace.device_ops.append(("frontend_dot_kernel<2>", 80_000_000,
                                 80_594_156))
    share = metric_reader(s, "frontend_roofline")(ctx)
    assert share == pytest.approx(25.0, rel=1e-3)
