"""The training data path of the port against the JAX package, on the CPU:
``TrainBatcher`` over one synthetic corpus with the same seed, in
fixed-length and in DCS mode, two epochs, equal bit for bit (arrays,
labels, durations); and the random policies' laws, as
``tests/test_stochastic_policies.py`` pins them for the JAX side:
frequency masking (width ``floor(U[0, 20))``, start uniform over
0 .. C - width inclusive), ``pad_random``'s exclusive crop bound, the DCS
target draw and crop; the same (width, start) masks the bank as the JAX
function does."""

import jax
import numpy as np
import pytest
import torch

from aasist_tpu.data import dataset as JD
from aasist_tpu.data import protocol as JP
from aasist_tpu.models.layers import freq_mask_filterbank as jax_freq_mask

from aasist_tpu_torch.data import dataset as D
from aasist_tpu_torch.data import protocol as P
from aasist_tpu_torch.data import synthetic
from aasist_tpu_torch.models import layers as L

from test_stochastic_policies import chi_square_uniform
from test_torch_train_models import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("LA")
    synthetic.generate(root, n_train=10, n_dev=2, n_eval=2, seed=13,
                       audio_format="wav")
    return root


@pytest.mark.parametrize("dcs", [False, True])
def test_train_batcher_equals_the_jax_batcher(corpus, dcs):
    base = corpus / "ASVspoof2019_LA_train"
    proto = (corpus / "ASVspoof2019_LA_cm_protocols"
             / "ASVspoof2019.LA.cm.train.trn.txt")
    labels, files = P.labels_and_files(P.parse_protocol(proto))
    j_labels, j_files = JP.labels_and_files(JP.parse_protocol(proto))
    assert (labels, files) == (j_labels, j_files)
    kw = {"batch_size": 4, "seed": 9, "fixed_len": 24000}
    if dcs:
        kw.update(dcs_buckets=D.bucket_lengths(4000, 40000, 4),
                  dcs_min=4000, dcs_max=40000)
        np.testing.assert_array_equal(kw["dcs_buckets"],
                                      JD.bucket_lengths(4000, 40000, 4))
    port = D.TrainBatcher(D.AudioStore(base), files, labels, **kw)
    ref = JD.TrainBatcher(JD.AudioStore(base), j_files, j_labels, **kw)
    assert len(port) == len(ref) == 2
    lengths = set()
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        for (x, y, d), (jx, jy, jd) in zip(got, want):
            assert x.dtype == torch.float32 and y.dtype == torch.int64
            np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
            lengths.add(x.shape[1])
    assert len(lengths) > 1 if dcs else lengths == {24000}


def test_freq_mask_law():
    """4,000 draws: every width 0 .. 19, uniform; each start within
    0 .. C - width, the inclusive top reached, uniform for the common
    widths."""
    c, n = 70, 4000
    g = torch.Generator().manual_seed(42)
    draws = [L.freq_mask_draw(g, c) for _ in range(n)]
    widths = np.asarray([w for w, _ in draws])
    assert set(np.unique(widths)) == set(range(20))
    chi2, bound = chi_square_uniform(np.bincount(widths, minlength=20))
    assert chi2 < bound, (chi2, bound)
    assert all(0 <= s <= c - w for w, s in draws)
    assert any(s == c - w for w, s in draws if w > 0)
    for w in (5, 10):
        ws = np.asarray([s for ww, s in draws if ww == w])
        chi2, bound = chi_square_uniform(np.bincount(ws, minlength=c - w + 1))
        assert chi2 < bound, (w, chi2, bound)


def test_freq_mask_rows_equal_the_jax_mask():
    """The JAX function's (width, start), drawn as it draws them, mask the
    bank as the port's ``freq_mask_rows`` does."""
    bank = np.random.default_rng(3).standard_normal((70, 129)).astype(
        np.float32)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        k_width, k_start = jax.random.split(key)
        width = int(jax.random.uniform(k_width) * 20.0)
        start = int(jax.random.randint(k_start, (), 0, 70 + 1 - width))
        want = np.asarray(jax_freq_mask(key, bank))
        got = L.freq_mask_rows(torch.from_numpy(bank), width, start)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (~want.any(axis=1)).sum() == width


def test_freq_mask_filterbank_draws_then_masks():
    bank = torch.ones(70, 5)
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    width, start = L.freq_mask_draw(g1, 70)
    got = L.freq_mask_filterbank(g2, bank)
    assert torch.equal(got, L.freq_mask_rows(bank, width, start))


def test_pad_random_laws():
    """The crop start's support is 0 .. n - max_len - 1 (the reference's
    exclusive bound), uniform; n == max_len returns x; shorter rows tile;
    equal to the JAX function on the same generator state."""
    n, max_len = 130, 100
    x = np.arange(n, dtype=np.float32)
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    starts = []
    for _ in range(4000):
        y = D.pad_random(x, max_len, rng)
        np.testing.assert_array_equal(y, JD.pad_random(x, max_len, jrng))
        starts.append(int(y[0]))
    starts = np.asarray(starts)
    assert starts.min() == 0 and starts.max() == n - max_len - 1
    chi2, bound = chi_square_uniform(np.bincount(starts,
                                                 minlength=n - max_len))
    assert chi2 < bound, (chi2, bound)
    np.testing.assert_array_equal(D.pad_random(x[:100], 100, rng), x[:100])
    np.testing.assert_array_equal(D.pad_random(x[:30], 100, rng),
                                  np.tile(x[:30], 4)[:100])


def test_dcs_laws():
    """Targets uniform over min .. max inclusive; the crop start over
    0 .. n - target inclusive; short rows tile then zero-pad; each equal to
    the JAX function's on the same generator state."""
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    lo, hi = 16000, 96000
    t = D.draw_chunk_targets(rng, 20000, lo, hi)
    np.testing.assert_array_equal(t, JD.draw_chunk_targets(jrng, 20000, lo,
                                                           hi))
    assert t.min() >= lo and t.max() <= hi
    counts = np.bincount((t - lo) * 40 // (hi - lo + 1), minlength=40)
    chi2, bound = chi_square_uniform(counts)
    assert chi2 < bound, (chi2, bound)
    x = np.arange(130, dtype=np.float32)
    starts = []
    for _ in range(3000):
        row, dur = D.dynamic_chunk(x, rng, 100, 120)
        jrow, jdur = JD.dynamic_chunk(x, jrng, 100, 120)
        np.testing.assert_array_equal(row, jrow)
        assert dur == jdur == 100 / 16000
        assert not row[100:].any()
        starts.append(int(row[0]))
    assert min(starts) == 0 and max(starts) == 30
    row, _ = D.dynamic_chunk(x[:30], rng, 100, 104)
    np.testing.assert_array_equal(row[:100], np.tile(x[:30], 4)[:100])
    buckets = D.bucket_lengths(16000, 96000, 6)
    assert D.snap_up_to_bucket(16001, buckets) == JD.snap_up_to_bucket(
        16001, buckets) == buckets[1]


def test_train_batcher_refuses_short_buckets(corpus):
    with pytest.raises(ValueError, match="must cover"):
        D.TrainBatcher(D.AudioStore(corpus), [], {}, batch_size=2, seed=0,
                       dcs_buckets=np.asarray([4000, 8000]), dcs_max=9000)
