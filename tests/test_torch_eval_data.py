"""The port's data layer against the JAX package's, on the CPU: the FLAC
decoder (its source, its samples, its errors), the FLAC encoder, the
synthetic corpus, protocol parsing and the eval batcher."""

import gc
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from aasist_tpu.data import audio_io as jax_audio_io
from aasist_tpu.data import dataset as jax_dataset
from aasist_tpu.data import flac_encode as jax_flac_encode
from aasist_tpu.data import flac_native as jax_flac_native
from aasist_tpu.data import protocol as jax_protocol
from aasist_tpu.data import synthetic as jax_synthetic

from aasist_tpu_torch.data import audio_io, dataset, flac_encode, flac_native
from aasist_tpu_torch.data import protocol, synthetic

from flac_reference_streams import ALL_STREAMS

ROOT = Path(__file__).resolve().parent.parent
EVAL_PROTOCOL = ("ASVspoof2019_LA_cm_protocols/"
                 "ASVspoof2019.LA.cm.eval.trl.txt")


def test_decoder_source_is_the_jax_packages():
    """The port builds its own copy of the decoder; the two copies must
    not drift."""
    assert (ROOT / "aasist_tpu_torch" / "csrc" / "flac_decoder.cpp"
            ).read_bytes() == (ROOT / "native" / "flac_decoder.cpp"
                               ).read_bytes()


@pytest.mark.parametrize("name", sorted(ALL_STREAMS))
def test_reference_streams_decode_as_the_jax_decoder(name):
    """Streams assembled from the FLAC specification, independently of
    either encoder: the same samples, bit for bit."""
    data, _expected = ALL_STREAMS[name]()
    got, sr = flac_native.read_flac_bytes(data)
    want, want_sr = jax_flac_native.read_flac_bytes(data)
    assert sr == want_sr
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_decode_errors_raise(tmp_path):
    stream, _ = ALL_STREAMS[sorted(ALL_STREAMS)[0]]()
    for bad in (b"RIFF not a flac stream", stream[:len(stream) // 2]):
        with pytest.raises(flac_native.FlacDecodeError) as got:
            flac_native.read_flac_bytes(bad)
        with pytest.raises(jax_flac_native.FlacDecodeError) as want:
            jax_flac_native.read_flac_bytes(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(flac_native.FlacDecodeError, match="cannot open"):
        flac_native.read_flac_f32(tmp_path / "missing.flac")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A decoder that does not compile raises FlacDecodeError: no other
    decoder is taken in its place."""
    bad = tmp_path / "flac_decoder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(flac_native, "SOURCE", bad)
    monkeypatch.setattr(flac_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(flac_native, "_lib", None)
    with pytest.raises(flac_native.FlacDecodeError, match="g\\+\\+ failed"):
        flac_native.read_flac_bytes(b"fLaC")


@pytest.mark.parametrize("kwargs", [
    {}, {"subframe_mode": "verbatim"}, {"subframe_mode": "lpc2"},
    {"partition_order": 2, "escape_partitions": True},
    {"block_size": 1000}, {"stereo": True, "mid_side": True},
    {"bps": 24}], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items())
    or "default")
def test_encoder_writes_the_jax_packages_bytes(kwargs, tmp_path):
    kwargs = dict(kwargs)
    rng = np.random.default_rng(21)
    bps = kwargs.get("bps", 16)
    x = np.round(np.sin(np.arange(5000) / 7.0) * 0.3 * 2 ** (bps - 1)
                 + rng.normal(0, 40, 5000)).astype(np.int64)
    if kwargs.pop("stereo", False):
        x = np.stack([x, np.roll(x, 3)], axis=1)
    flac_encode.write_flac(tmp_path / "port.flac", x, 16000, **kwargs)
    jax_flac_encode.write_flac(tmp_path / "jax.flac", x, 16000, **kwargs)
    assert (tmp_path / "port.flac").read_bytes() == \
        (tmp_path / "jax.flac").read_bytes()
    got, _ = audio_io.read_audio(tmp_path / "port.flac")
    np.testing.assert_array_equal(
        np.round(got * 2 ** (bps - 1)).astype(np.int64), x)


def _tree(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("seed,fmt", [(77, "flac"), (99, "wav")])
def test_synthetic_corpus_is_the_jax_packages(seed, fmt, tmp_path):
    """The e2e goldens' corpora (seed 77 in FLAC, seed 99 in WAV) at small
    counts: the same files, byte for byte, and the same ids."""
    kw = dict(n_train=1, n_dev=1, n_eval=5, seed=seed, audio_format=fmt)
    ids = synthetic.generate(tmp_path / "port", **kw)
    want = jax_synthetic.generate(tmp_path / "jax", **kw)
    assert ids == want
    got_tree, want_tree = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got_tree) == sorted(want_tree)
    assert sum(k.endswith("." + fmt) for k in got_tree) == 7
    assert got_tree == want_tree


@pytest.fixture(scope="module")
def corpus77(tmp_path_factory):
    """The seed-77 corpus of the e2e golden (4/4/48 utterances, FLAC)."""
    root = tmp_path_factory.mktemp("la77")
    synthetic.generate(root, n_train=4, n_dev=4, n_eval=48, seed=77)
    return root


def test_corpus_decodes_as_the_jax_decoder(corpus77):
    """Every utterance of the seed-77 corpus: the port's float64 and
    float32 reads equal the JAX decoder's, and the store's rows equal the
    JAX store's."""
    files = sorted(corpus77.rglob("*.flac"))
    assert len(files) == 56
    for path in files:
        got, sr = flac_native.read_flac(path)
        want, want_sr = jax_flac_native.read_flac(path)
        assert sr == want_sr == 16000
        np.testing.assert_array_equal(got, want)
        got32, _ = flac_native.read_flac_f32(path)
        want32, _ = jax_flac_native.read_flac_f32(path)
        assert got32.dtype == np.float32
        np.testing.assert_array_equal(got32, want32)
        np.testing.assert_array_equal(got32, want.astype(np.float32))
    split = corpus77 / "ASVspoof2019_LA_eval"
    store, jax_store = dataset.AudioStore(split), jax_dataset.AudioStore(split)
    for path in sorted((split / "flac").glob("*.flac"))[:4]:
        np.testing.assert_array_equal(store.read(path.stem),
                                      jax_store.read(path.stem))


def test_protocol_is_the_jax_packages(corpus77):
    path = corpus77 / EVAL_PROTOCOL
    got, want = protocol.parse_protocol(path), jax_protocol.parse_protocol(
        path)
    assert len(got) == 48
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert [e.label for e in got] == [e.label for e in want]
    assert protocol.trial_metadata(got) == jax_protocol.trial_metadata(want)
    assert protocol.labels_and_files(got) == \
        jax_protocol.labels_and_files(want)


@pytest.mark.parametrize("fmt", ["flac", "wav"])
def test_audio_readers_are_the_jax_packages(corpus77, fmt, tmp_path):
    if fmt == "flac":
        path = next(corpus77.rglob("*.flac"))
    else:
        path = tmp_path / "x.wav"
        wave = np.random.default_rng(5).uniform(-0.6, 0.6, 3001)
        audio_io.write_wav(path, wave, 16000)
        jax_audio_io.write_wav(tmp_path / "jax.wav", wave, 16000)
        assert path.read_bytes() == (tmp_path / "jax.wav").read_bytes()
    got, sr = audio_io.read_audio(path)
    want, want_sr = jax_audio_io.read_audio(path)
    assert sr == want_sr
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch_size", [1, 3, 8])
def test_eval_batcher_is_the_jax_packages(corpus77, batch_size):
    """The same (batch, ids, n_real) triples in the same order, the last
    batch ragged at 3 and 8 (20 utterances), its rows padded by repeating
    the last; the port's batches stay on the host."""
    ids = [e.utt_id for e in protocol.parse_protocol(
        corpus77 / EVAL_PROTOCOL)][:20]
    split = corpus77 / "ASVspoof2019_LA_eval"
    got = list(dataset.EvalBatcher(dataset.AudioStore(split), ids,
                                   batch_size=batch_size, fixed_len=16000))
    want = list(jax_dataset.EvalBatcher(jax_dataset.AudioStore(split), ids,
                                        batch_size=batch_size,
                                        fixed_len=16000))
    assert len(got) == len(want) == -(-20 // batch_size)
    for (x, utts, n), (wx, wutts, wn) in zip(got, want):
        assert isinstance(x, np.ndarray) and x.dtype == np.float32
        assert x.shape == (batch_size, 16000)
        np.testing.assert_array_equal(x, np.asarray(wx))
        assert (utts, n) == (wutts, wn)
    assert got[-1][2] == 20 - batch_size * (len(got) - 1)


def _extra_threads():
    return {t for t in threading.enumerate()
            if t is not threading.main_thread() and t.is_alive()}


def test_batcher_thread_stops_when_the_consumer_breaks(corpus77):
    store = dataset.AudioStore(corpus77 / "ASVspoof2019_LA_eval")
    ids = [e.utt_id for e in protocol.parse_protocol(
        corpus77 / EVAL_PROTOCOL)]
    base = _extra_threads()
    for _ in range(3):
        for batch in dataset.EvalBatcher(store, ids, batch_size=2,
                                         prefetch=1, fixed_len=8000):
            break            # the producer is blocked on the full queue
    gc.collect()
    deadline = time.time() + 5.0
    while (leaked := _extra_threads() - base) and time.time() < deadline:
        time.sleep(0.05)
    assert not leaked, f"producer threads left running: {leaked}"
    assert batch[0].shape == (2, 8000)


def test_batcher_errors_raise(corpus77):
    store = dataset.AudioStore(corpus77 / "ASVspoof2019_LA_eval")
    with pytest.raises(FileNotFoundError, match="LA_E_MISSING"):
        list(dataset.EvalBatcher(store, ["LA_E_7700000", "LA_E_MISSING"],
                                 batch_size=3, fixed_len=8000))
