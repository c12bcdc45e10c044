"""The port's pipelined dispatch and packaged configs, on the CPU.

``aasist_tpu_torch.utils.dispatch.pipelined`` against the JAX package's
``aasist_tpu.utils.dispatch.pipelined`` (the same calls in the same order);
the Scorer's pipelined scoring against a serial loop of forwards; and a
config resolved from a copy of the package outside the checkout.
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
from aasist_tpu.utils.dispatch import pipelined as jax_pipelined

from aasist_tpu_torch.config import PACKAGED_CONFIGS, resolve_config_path
from aasist_tpu_torch.data.dataset import pad_into, pad_to_fixed
from aasist_tpu_torch.ops.long_audio import make_windows, score_long_audio
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.serving import Scorer
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


def test_packaged_configs_are_the_checkouts():
    names = sorted(p.name for p in (ROOT / "configs").glob("*.conf"))
    assert sorted(p.name for p in PACKAGED_CONFIGS.glob("*.conf")) == names
    for name in names:
        assert (PACKAGED_CONFIGS / name).read_bytes() == \
            (ROOT / "configs" / name).read_bytes()
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
