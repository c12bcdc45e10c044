"""The one traffic generator: a seed gives the same inputs every time,
another seed other inputs of the same sizes."""

import itertools
import json

import numpy as np

from portbench.lib import traffic
from portbench.tests.cells import HARNESS, TRAFFIC


def _mix(name):
    return json.loads((HARNESS / "traffic" / f"{name}.json").read_text())


def test_pool_repeats_for_a_seed_and_differs_for_another():
    mix = TRAFFIC["shards"]
    a, b = traffic.make_pool(mix, 7, "cpu"), traffic.make_pool(mix, 7, "cpu")
    c = traffic.make_pool(mix, 8, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(len(x) == len(y) and np.array_equal(x, y)
                   for x, y in zip(a, c))
    # the same lengths in another order
    assert sorted(map(len, a)) == sorted(map(len, c))
    assert [len(x) for x in a] != [len(x) for x in c]


def test_lengths_follow_the_mix():
    mix = _mix("corpus-shards")
    n = traffic.quantile_lengths(mix["lengths"], mix["pool"])
    assert n.min() >= 16000 and n.max() <= 12 * 16000
    assert abs(np.median(n) / 16000 - 3.0) < 0.01


def test_requests_repeat_and_take_each_size_once_a_block():
    mix = TRAFFIC["requests"]
    take = lambda s: [r.tolist() for r in itertools.islice(  # noqa: E731
        traffic.requests(mix, s), 30)]
    assert take(3) == take(3) and take(3) != take(4)
    sizes = [len(r) for r in take(3)]
    for i in range(0, 30, 3):
        assert sorted(sizes[i:i + 3]) == [1, 2, 4]
    assert all(len(set(r)) == len(r) for r in take(3))


def test_whole_pool_requests_are_permutations():
    mix = TRAFFIC["shards"]
    for r in itertools.islice(traffic.requests(mix, 1), 3):
        assert sorted(r) == list(range(mix["pool"]))


def test_due_times():
    mix = dict(TRAFFIC["requests"],
               arrivals={"loop": "open", "rate_per_s": 4.0, "gaps": "fixed"})
    due = list(itertools.islice(traffic.due_times(mix), 5))
    assert due == [0.0, 0.25, 0.5, 0.75, 1.0]
    closed = dict(mix, arrivals={"loop": "closed"})
    assert next(traffic.due_times(closed)) is None


def test_corpus_labels_and_pcm(tmp_path):
    mix = TRAFFIC["train"]
    ids, pcm, labels = traffic.make_corpus(mix, 3, "cpu")
    assert len(ids) == 40 and sum(labels.values()) == 10
    assert all(p.dtype == np.dtype("<i2") for p in pcm)
    ids2, pcm2, labels2 = traffic.make_corpus(mix, 3, "cpu")
    assert labels == labels2 and all(
        np.array_equal(x, y) for x, y in zip(pcm, pcm2))
    traffic.write_wavs(tmp_path, ids[:2], pcm[:2])
    from aasist_tpu_torch.data.audio_io import read_wav
    x, sr = read_wav(tmp_path / f"{ids[0]}.wav")
    assert sr == 16000 and np.array_equal(x * 32768.0, pcm[0])
