"""The port's pipelined dispatch and packaged configs, on the CPU.

``aasist_tpu_torch.utils.dispatch.pipelined`` against the JAX package's
``aasist_tpu.utils.dispatch.pipelined`` (the same calls in the same order);
the Scorer's pipelined scoring against a serial loop of forwards; the
Scorer's row buckets and its counters; and a config resolved from a copy
of the package outside the checkout.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aasist_tpu.ops.long_audio import score_long_audio as jax_long_audio
from aasist_tpu.registry import list_architectures as jax_architectures
from aasist_tpu.utils.dispatch import pipelined as jax_pipelined

from aasist_tpu_torch.config import (PACKAGED_CONFIGS, load_config,
                                     resolve_config_path)
from aasist_tpu_torch.data.dataset import pad_into, pad_to_fixed
from aasist_tpu_torch.ops.long_audio import make_windows, score_long_audio
from aasist_tpu_torch.parallel.mesh import DataMesh
from aasist_tpu_torch.registry import build_model, list_architectures
from aasist_tpu_torch.serving import Scorer, row_buckets
from aasist_tpu_torch.utils.dispatch import pipelined, record

ROOT = Path(__file__).resolve().parent.parent

SMALL_CONF = {
    "architecture": "AASIST",
    "first_conv": 128,
    "filts": [70, [1, 8], [8, 8], [8, 12], [12, 12]],
    "gat_dims": [12, 16],
    "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}
WINDOW = 16000
BATCH = 4
# The CPU forward is not bit-reproducible from one call to the next in
# every run: under the suite's parallel workers, one row of a first forward
# once came out 1.8e-7 (about 12 float32 ulps of its 0.22 score) off the
# serial loop's, and no rerun reproduced it.  Scores are held to the serial
# loop's within SCORE_ATOL, and each score must lie nearest its own serial
# score, so the order check stays exact.  The model is seeded and each
# utterance has its own level (amplitude 0.05 * 1.5**i), which spreads the
# scores: the smallest gap between two of them here is 6.5e-4, over 600
# times SCORE_ATOL (_assert_scores_match asserts more than twice it).
SCORE_ATOL = 1e-6


def _trace(fn, n_items, depth):
    """The calls ``fn`` makes, in order: ("dispatch", i) and ("drain", i),
    and how many tickets were in flight at most."""
    log, live = [], [0, 0]

    def dispatch(i):
        log.append(("dispatch", i))
        live[0] += 1
        live[1] = max(live[1], live[0])
        return i

    def drain(ticket):
        log.append(("drain", ticket))
        live[0] -= 1

    fn(range(n_items), dispatch, drain, depth)
    return log, live[1]


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_pipelined_matches_the_jax_package(depth):
    for n_items in (0, 1, 2, 3, 7):
        got, most = _trace(pipelined, n_items, depth)
        want, want_most = _trace(jax_pipelined, n_items, depth)
        assert got == want
        assert most == want_most == min(n_items, depth + 1)
        # every ticket is drained once, in dispatch order
        assert [i for k, i in got if k == "drain"] == list(range(n_items))


@pytest.mark.parametrize("n", [1, 3, 7, 16000, 32299, 32300, 32301, 64599,
                               64600, 64601, 100000])
def test_pad_into_is_pad_to_fixed(n):
    """The Scorer pads each request straight into its pinned buffer: the
    reference's crop or tile-repeat, written in place."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    dst = np.full(64600, np.nan, np.float32)
    np.testing.assert_array_equal(pad_into(dst, x), pad_to_fixed(x))


@pytest.fixture(scope="module")
def model():
    with torch.random.fork_rng():
        torch.manual_seed(1)
        m = build_model(SMALL_CONF)
    rng = np.random.default_rng(3)
    with torch.no_grad():        # BatchNorm off its identity init
        for bn in m.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                n = bn.running_mean.shape
                bn.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, n).astype(np.float32)))
                bn.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, n).astype(np.float32)))
    return m


def _assert_scores_match(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if len(want) > 1:           # the nearest-score check is unambiguous
        assert np.diff(np.sort(want)).min() > 2 * SCORE_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    nearest = np.abs(got[:, None] - want[None, :]).argmin(axis=1)
    np.testing.assert_array_equal(nearest, np.arange(len(want)))


def _serial(model, rows):
    """Scores of (n, WINDOW) rows, one forward per batch of BATCH padded by
    repeating the last row: the loop the Scorer ran before it pipelined."""
    out = []
    for i in range(0, len(rows), BATCH):
        chunk = rows[i:i + BATCH]
        n = len(chunk)
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], BATCH - n, 0)])
        with torch.inference_mode():
            _, logits = model(torch.from_numpy(chunk))
        out.extend(logits[:n, 1].float().numpy().tolist())
    return np.asarray(out)


@pytest.mark.parametrize("n_waves", [BATCH, 2 * BATCH + 3, 1],
                         ids=["full", "ragged", "one row"])
def test_pipelined_scores_match_the_serial_loop(model, n_waves):
    """Scores and their order equal a serial loop of forwards (to
    SCORE_ATOL, each nearest its own): a full batch, three batches with a
    ragged last, and a one-row batch."""
    rng = np.random.default_rng(n_waves)
    waves = [(rng.standard_normal(n) * 0.05 * 1.5 ** i).astype(np.float32)
             for i, n in enumerate(rng.integers(4000, 30000, n_waves))]
    scorer = Scorer(model, device="cpu", bf16=False, window=WINDOW,
                    batch_size=BATCH)
    got = scorer.score_waveforms(waves)
    rows = np.stack([pad_to_fixed(w, WINDOW) for w in waves])
    _assert_scores_match(np.asarray(got, np.float32),
                         _serial(scorer.model, rows).astype(np.float32))


@pytest.mark.parametrize("n_waves", [2, 5, 1], ids=["full", "ragged",
                                                    "one row"])
def test_pipelined_long_audio_matches_the_serial_loop(model, n_waves):
    """With long_audio, every utterance's mean over its windows equals the
    serial loop's (to SCORE_ATOL, each nearest its own): the windows of all
    utterances batched in order (two full, seven ragged and one window
    here)."""
    rng = np.random.default_rng(10 + n_waves)
    lengths = {2: (40000, 9000), 5: (40000, 70000, 12000, 16000, 30000),
               1: (5000,)}[n_waves]
    waves = [(rng.standard_normal(n) * 0.05 * 1.5 ** i).astype(np.float32)
             for i, n in enumerate(lengths)]
    scorer = Scorer(model, device="cpu", bf16=False, window=WINDOW,
                    batch_size=BATCH)
    got = scorer.score_waveforms(waves, long_audio=True)
    # the scorer keeps the default hop, half the 64,600 window
    wins = [make_windows(w, WINDOW) for w in waves]
    flat = _serial(scorer.model, np.concatenate(wins).astype(np.float32))
    want, i = [], 0
    for w in wins:
        want.append(float(np.mean(flat[i:i + len(w)])))
        i += len(w)
    _assert_scores_match(got, want)


def test_long_audio_batches_keep_one_shape():
    """Every batch the scorer sees has batch_size rows, the tail padded by
    repeating its last row, and the scores equal the JAX package's
    score_long_audio with the same scorer."""
    rng = np.random.default_rng(8)
    waves = [rng.standard_normal(n).astype(np.float32)
             for n in (900, 2500, 300, 4100)]
    shapes = []

    def scorer(rows):
        shapes.append(rows.shape)
        return rows[:, ::7].sum(axis=1) + rows[:, -1]

    kw = dict(window=1000, hop=500, batch_size=4)
    got = score_long_audio(waves, scorer, np.asarray, **kw)
    ported_shapes, shapes[:] = list(shapes), []
    want = jax_long_audio(waves, scorer, **kw)
    assert ported_shapes == shapes == [(4, 1000)] * 4   # 14 windows
    np.testing.assert_array_equal(got, want)


def test_batch_event_is_recorded_on_the_scorers_device(monkeypatch):
    """The copies and the forward of a batch are queued on the scorer's
    device's current stream, which need not be the current device's: its
    event is recorded there."""
    streams = {}

    class Event:
        def record(self, stream=None):
            self.stream = stream

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: streams.setdefault(
                            str(device), object()))
    event = record(torch.device("cuda", 1))
    assert event.stream is streams["cuda:1"]


def test_score_batch_keeps_its_contract(model):
    scorer = Scorer(model, device="cpu", bf16=False, window=WINDOW,
                    batch_size=BATCH)
    rows = (np.random.default_rng(4).standard_normal((3, WINDOW))
            * 0.05 * 1.5 ** np.arange(3)[:, None]).astype(np.float32)
    got = scorer.score_batch(rows)
    assert got.shape == (3,)
    _assert_scores_match(got, _serial(scorer.model, rows).astype(np.float32))
    assert scorer.score_batch(rows[:0]).shape == (0,)
    with pytest.raises(ValueError, match="exceeds batch_size"):
        scorer.score_batch(np.zeros((BATCH + 1, WINDOW), np.float32))
    with pytest.raises(ValueError, match="expected window"):
        scorer.score_batch(np.zeros((2, WINDOW + 1), np.float32))


class _RowsSeen(torch.nn.Module):
    """A model stub: records each forward's row count and scores a row by
    its mean."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, x):
        self.seen.append(x.shape[0])
        m = x.mean(dim=1)
        return x, torch.stack([-m, m], dim=1)


STUB_WINDOW = 32


def _stub_scorer(batch_size, **kw):
    return Scorer(_RowsSeen(), device="cpu", bf16=False, window=STUB_WINDOW,
                  batch_size=batch_size, **kw)


def _row_means(waves):
    """The stub's scores of ``waves``, one row at a time."""
    return np.array([torch.from_numpy(w[None]).mean(dim=1).item()
                     for w in waves], np.float32)


def _stub_waves(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(STUB_WINDOW).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("batch_size,n,rows", [
    (128, 1, 16), (128, 2, 16), (128, 15, 16), (128, 16, 16),
    (128, 17, 32), (128, 33, 64), (128, 100, 128), (128, 128, 128),
    (4, 1, 4), (4, 3, 4), (256, 200, 256)])
def test_a_batch_runs_at_the_smallest_bucket_that_holds_it(batch_size, n,
                                                           rows):
    """n rows run at the smallest of 16, 32, ... batch_size that holds them
    (batch_size alone at 16 or less), each real row scored as its own and
    the padding's scores dropped."""
    scorer = _stub_scorer(batch_size)
    waves = _stub_waves(n, seed=n)
    got = scorer.score_batch(np.stack(waves))
    assert scorer.model.seen == [rows]
    np.testing.assert_array_equal(got, _row_means(waves))


def test_row_buckets():
    assert row_buckets(128) == (16, 32, 64, 128)
    assert row_buckets(256) == (16, 32, 64, 128, 256)
    assert row_buckets(100) == (16, 32, 64, 100)
    assert row_buckets(16) == (16,)
    assert row_buckets(2) == (2,)


@pytest.mark.parametrize("n", [1, 5, 16])
def test_a_bucketed_request_scores_as_the_serial_loop(model, n):
    """A request of n <= 16 rows to a scorer of 32 runs one 16-row forward,
    and its scores equal the serial loop's of BATCH-row batches (to
    SCORE_ATOL, each nearest its own)."""
    rng = np.random.default_rng(20 + n)
    waves = [(rng.standard_normal(m) * 0.05 * 1.5 ** (i % 8)
              ).astype(np.float32)
             for i, m in enumerate(rng.integers(4000, 30000, n))]
    scorer = Scorer(model, device="cpu", bf16=False, window=WINDOW,
                    batch_size=32)
    got = scorer.score_waveforms(waves)
    assert scorer.counters["by_rows"] == {16: 1, 32: 0}
    rows = np.stack([pad_to_fixed(w, WINDOW) for w in waves])
    _assert_scores_match(np.asarray(got, np.float32),
                         _serial(scorer.model, rows).astype(np.float32))


def test_a_mesh_scorer_keeps_full_batches():
    """Over a mesh of two devices every batch runs at batch_size, half on
    each, whatever its real rows."""
    scorer = _stub_scorer(32, mesh=DataMesh(["cpu", "cpu"]))
    assert scorer.buckets == (32,)
    waves = _stub_waves(37)
    got = scorer.score_waveforms(waves)
    assert scorer.model.seen == [16, 16, 16, 16]
    np.testing.assert_array_equal(got, _row_means(waves))
    assert scorer.counters == {"batches": 2, "rows": 37, "rows_run": 64,
                               "by_rows": {32: 2}}


def test_warmup_runs_each_bucket_once():
    scorer = _stub_scorer(128)
    scorer.warmup()
    assert scorer.model.seen == [128, 64, 32, 16]
    assert scorer.counters["by_rows"] == {16: 1, 32: 1, 64: 1, 128: 1}


def test_counters_count_a_mixed_call():
    """Running totals over a call of two full batches and a ragged 17, a
    3-row score_batch and an empty one; each batch publishes a new dict
    and leaves the one read before it as it was."""
    scorer = _stub_scorer(128)
    before = scorer.counters
    assert before == {"batches": 0, "rows": 0, "rows_run": 0,
                      "by_rows": {16: 0, 32: 0, 64: 0, 128: 0}}
    scorer.score_waveforms(_stub_waves(2 * 128 + 17))
    scorer.score_batch(np.stack(_stub_waves(3)))
    scorer.score_batch(np.zeros((0, STUB_WINDOW), np.float32))
    assert scorer.model.seen == [128, 128, 32, 16]
    assert scorer.counters == {"batches": 4, "rows": 276, "rows_run": 304,
                               "by_rows": {16: 1, 32: 1, 64: 0, 128: 2}}
    assert before == {"batches": 0, "rows": 0, "rows_run": 0,
                      "by_rows": {16: 0, 32: 0, 64: 0, 128: 0}}


def test_packaged_configs_are_the_checkouts():
    """Every stock config of the checkout is packaged byte for byte; the
    package's other configs are of architectures only the port has (the
    checkout's ``configs/`` is the JAX package's data too)."""
    names = sorted(p.name for p in (ROOT / "configs").glob("*.conf"))
    packaged = sorted(p.name for p in PACKAGED_CONFIGS.glob("*.conf"))
    assert set(names) <= set(packaged)
    for name in names:
        assert (PACKAGED_CONFIGS / name).read_bytes() == \
            (ROOT / "configs" / name).read_bytes()
    extras = sorted(set(packaged) - set(names))
    assert extras == ["SSL_AASIST.conf"]
    for name in extras:
        arch = load_config(PACKAGED_CONFIGS / name).model_config[
            "architecture"]
        assert arch in list_architectures()
        assert arch not in jax_architectures()
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert '"aasist_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh", ' \
        '"csrc/*.cpp", "configs/*.conf"]' in pyproject


@pytest.mark.parametrize("spelling", ["AASIST", "AASIST.conf",
                                      "configs/AASIST.conf"])
def test_config_resolves_outside_the_checkout(tmp_path, spelling):
    """A copy of the package in a directory with no configs/ beside it:
    each spelling resolves to the copy's packaged config, and
    Scorer.from_config builds the model from it with the checkout's
    weights."""
    site = tmp_path / "site"
    shutil.copytree(ROOT / "aasist_tpu_torch", site / "aasist_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    work = tmp_path / "work"
    work.mkdir()
    code = (
        "import json\n"
        "import aasist_tpu_torch\n"
        "from aasist_tpu_torch.config import resolve_config_path\n"
        "from aasist_tpu_torch.serving import Scorer\n"
        f"p = resolve_config_path({spelling!r})\n"
        f"s = Scorer.from_config({spelling!r}, weights_path="
        f"{str(ROOT / 'checkpoints' / 'AASIST.npz')!r}, device='cpu',\n"
        "                        bf16=False)\n"
        "print(json.dumps([str(p), s.batch_size,\n"
        "                  aasist_tpu_torch.__file__]))\n")
    env = {**os.environ, "PYTHONPATH": str(site)}
    res = subprocess.run([sys.executable, "-c", code], cwd=work, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    path, batch, pkg = json.loads(res.stdout.strip().splitlines()[-1])
    assert Path(pkg).parent == site / "aasist_tpu_torch"
    assert Path(path) == site / "aasist_tpu_torch" / "configs" / \
        "AASIST.conf"
    assert batch == 128
    with pytest.raises(FileNotFoundError, match="packaged"):
        resolve_config_path("NoSuchModel")
