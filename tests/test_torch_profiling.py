"""``aasist_tpu_torch/utils/profiling.py`` and ``data/download.py`` on the
CPU: ``Timer``'s statistics over its repetitions (after the warm-up),
``trace`` writing a Chrome trace that holds an ``annotate`` span, and
``download`` on a ``file://`` zip made here (no network), with its error
for a zip that holds no ``LA/``."""

import json
import zipfile

import pytest
import torch

from aasist_tpu_torch.data import download as dl
from aasist_tpu_torch.utils import profiling


def test_timer_statistics(monkeypatch):
    clock = iter([0.0, 1.0, 1.0, 4.0, 4.0, 6.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    calls = []

    def fn(v):
        calls.append(v)
        return torch.tensor(float(v))

    stats = profiling.Timer(fn, warmup=2, reps=3).measure(7)
    assert calls == [7] * 5
    assert stats == {"mean_s": 2.0, "min_s": 1.0, "max_s": 3.0,
                     "median_s": 2.0}


def test_trace_holds_the_annotated_span(tmp_path):
    with profiling.trace(tmp_path / "t"):
        with profiling.annotate("aasist_batch"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aasist_batch" in names
    assert any(n and "mm" in n for n in names)


def _zip(path, root):
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr(f"{root}/ASVspoof2019_LA_cm_protocols/x.txt", "a b c\n")
    return path.resolve().as_uri()


def test_download_extracts_a_file_url(tmp_path):
    url = _zip(tmp_path / "src.zip", "LA")
    la = dl.download(tmp_path / "dest", url=url)
    assert la == tmp_path / "dest" / "LA"
    assert (la / "ASVspoof2019_LA_cm_protocols" / "x.txt").read_text() \
        == "a b c\n"
    assert not (tmp_path / "dest" / "LA.zip.part").exists()


def test_download_refuses_a_zip_without_la(tmp_path):
    url = _zip(tmp_path / "src.zip", "PA")
    with pytest.raises(RuntimeError, match="LA/ root"):
        dl.download(tmp_path / "dest", url=url)


def test_download_failure_names_the_synthetic_corpus(tmp_path):
    url = (tmp_path / "missing.zip").resolve().as_uri()
    with pytest.raises(RuntimeError, match="aasist_tpu_torch.data import "
                                           "synthetic"):
        dl.download(tmp_path / "dest", url=url)
