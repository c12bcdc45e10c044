"""The port's spans and counters on the CPU: under ``profiling.trace`` a
CPU ``Scorer`` records ``serving.dispatch`` > ``serving.forward`` > the
forward's stages for each batch (AASIST and AASIST2), each dispatch and
drain with the batch's sequence number; ``make_train_step`` records
``train.step`` and its four children, the blocks' recompute outside the
block spans; ``TrainBatcher.counters`` counts the batches made and only
grows."""

import contextlib

import numpy as np
import pytest
import torch

from aasist_tpu_torch import serving
from aasist_tpu_torch.config import OptimConfig
from aasist_tpu_torch.data import dataset as D
from aasist_tpu_torch.data import protocol as P
from aasist_tpu_torch.data import synthetic
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.train.loop import make_train_step
from aasist_tpu_torch.train.losses import weighted_cce
from aasist_tpu_torch.train.optim import create_optimizer, make_schedule
from aasist_tpu_torch.utils import profiling

from test_torch_train_models import one_torch_thread  # noqa: F401

AASIST = {
    "architecture": "AASIST", "first_conv": 128,
    "filts": [70, [1, 4], [4, 4], [4, 8], [8, 8]],
    "gat_dims": [8, 12], "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}
AASIST2 = {**AASIST, "res2net_width": 4, "res2net_scale": 2,
           "filts": [70, [1, 16], [16, 16], [16, 16], [16, 16]]}
WINDOW = 16000
BATCH = 2
STAGES = (["model.input", "model.frontend"]
          + [f"model.block{i}" for i in range(6)] + ["model.graph"])
PROGRAM = ("serving.", "model.", "train.")


def _spans(prof):
    """The program's spans of a finished window: (name, start, end) ns,
    outer before inner."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()
                   and e.name().startswith(PROGRAM)),
                  key=lambda s: (s[1], -s[2]))


def _inside(spans, outer):
    return [s for s in spans if s is not outer
            and outer[1] <= s[1] and s[2] <= outer[2]]


def _children(spans, outer):
    """The names of the spans directly inside ``outer``, in order."""
    inner = _inside(spans, outer)
    return [s[0] for s in inner
            if not any(t is not s and t[1] <= s[1] and s[2] <= t[2]
                       for t in inner)]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.mark.parametrize("conf", [AASIST, AASIST2],
                         ids=["AASIST", "AASIST2"])
def test_scorer_records_each_batchs_spans(tmp_path, conf):
    torch.manual_seed(0)
    scorer = serving.Scorer(build_model(conf), device="cpu", bf16=False,
                            window=WINDOW, batch_size=BATCH)
    rng = np.random.default_rng(0)
    waves = [(rng.standard_normal(n) * 0.05).astype(np.float32)
             for n in (9000, 16000, 20000)]
    with profiling.trace(tmp_path / "t") as prof:
        scorer.score_waveforms(waves)
    spans = _spans(prof)
    dispatches = _named(spans, "serving.dispatch")
    assert len(dispatches) == 2 and len(_named(spans, "serving.drain")) == 2
    for d in dispatches:
        assert _children(spans, d) == ["serving.forward"]
        forward, = [s for s in _inside(spans, d)
                    if s[0] == "serving.forward"]
        assert _children(spans, forward) == STAGES


def test_dispatch_and_drain_carry_the_batchs_number(monkeypatch):
    calls = []

    def annotate(name, args=None):
        calls.append((name, args))
        return contextlib.nullcontext()

    monkeypatch.setattr(serving, "annotate", annotate)
    torch.manual_seed(0)
    scorer = serving.Scorer(build_model(AASIST), device="cpu", bf16=False,
                            window=WINDOW, batch_size=BATCH)
    waves = [np.full(WINDOW, 0.01 * i, np.float32) for i in range(5)]
    scorer.score_waveforms(waves)
    numbered = [c for c in calls if c[1] is not None]
    assert [c for c in numbered if c[0] == "serving.dispatch"] == [
        ("serving.dispatch", i) for i in range(3)]
    assert [c for c in numbered if c[0] == "serving.drain"] == [
        ("serving.drain", i) for i in range(3)]


def test_train_step_records_its_spans(tmp_path):
    torch.manual_seed(0)
    model = build_model(AASIST).train()
    cfg = OptimConfig.from_dict({"optimizer": "adam", "base_lr": 1e-3,
                                 "scheduler": "none"})
    optimizer = create_optimizer(cfg, model.parameters())
    step = make_train_step(
        model, lambda lg, y, d: weighted_cce(lg, y), optimizer,
        make_schedule(cfg), seed=3, freq_aug=False, use_duration=False)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((4, WINDOW)) * 0.05)
                         .astype(np.float32))
    with profiling.trace(tmp_path / "t") as prof:
        step(x, torch.tensor([0, 1, 0, 1]), torch.ones(4), 0)
    spans = _spans(prof)
    train_step, = _named(spans, "train.step")
    assert _children(spans, train_step) == [
        "train.zero_grad", "train.forward", "train.backward",
        "train.optimizer"]
    forward, = _named(spans, "train.forward")
    assert _children(spans, forward) == STAGES
    # the blocks' recompute in the backward runs outside the block spans
    backward, = _named(spans, "train.backward")
    assert _inside(spans, backward) == []


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("LA")
    synthetic.generate(root, n_train=10, n_dev=2, n_eval=2, seed=13,
                       audio_format="wav")
    proto = (root / "ASVspoof2019_LA_cm_protocols"
             / "ASVspoof2019.LA.cm.train.trn.txt")
    labels, files = P.labels_and_files(P.parse_protocol(proto))
    return D.AudioStore(root / "ASVspoof2019_LA_train"), files, labels


def test_train_batcher_counts_its_batches(corpus):
    store, files, labels = corpus
    batcher = D.TrainBatcher(store, files, labels, batch_size=2, seed=9,
                             fixed_len=24000, prefetch=1)
    keys = ("batches", "rows_ms", "collate_ms", "pin_ms", "produce_ms")
    assert batcher.counters == dict.fromkeys(keys, 0)
    seen = [dict(batcher.counters)]
    for epoch in (0, 1):
        batcher.set_epoch(epoch)
        it = iter(batcher)
        for k in range(1, len(batcher) + 1):
            next(it)
            taken = epoch * len(batcher) + k
            # the producer runs ahead by the queue and the batch it holds
            assert taken <= batcher.counters["batches"] <= taken + 2
            seen.append(dict(batcher.counters))
        assert list(it) == []
        assert batcher.counters["batches"] == (epoch + 1) * len(batcher)
    seen.append(dict(batcher.counters))
    for before, after in zip(seen, seen[1:]):
        assert all(after[k] >= before[k] for k in keys)
    c = batcher.counters
    assert c["rows_ms"] > 0 and c["collate_ms"] > 0
    assert c["produce_ms"] >= c["rows_ms"] + c["collate_ms"] + c["pin_ms"]


def test_two_live_iterators_lose_no_count(corpus):
    """A dropped iterator's producer may still run beside a new one's:
    both publish their batches, and none is lost."""
    store, files, labels = corpus
    batcher = D.TrainBatcher(store, files, labels, batch_size=2, seed=9,
                             fixed_len=24000, prefetch=1, num_threads=2)
    first, second = iter(batcher), iter(batcher)
    assert len(list(second)) == len(list(first)) == len(batcher)
    assert batcher.counters["batches"] == 2 * len(batcher)
