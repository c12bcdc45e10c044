"""``aasist_tpu_torch/utils/profiling.py`` and ``data/download.py`` on the
CPU: ``trace`` writing a Chrome trace that holds an ``annotate`` span,
``annotate`` making no call into the profiler while none records, and
``download`` on a ``file://`` zip made here (no network), with its error
for a zip that holds no ``LA/``."""

import json
import zipfile

import pytest
import torch

from aasist_tpu_torch.data import download as dl
from aasist_tpu_torch.utils import profiling


class _NoProfilerOps:
    """Stands in for ``torch.ops.profiler``: any use of it fails."""

    def __getattr__(self, name):
        raise AssertionError(f"torch.ops.profiler.{name} was called")


def test_annotate_makes_no_profiler_call_while_none_records(monkeypatch):
    monkeypatch.setattr(torch.ops, "profiler", _NoProfilerOps())
    first = profiling.annotate("serving.dispatch", 3)
    with first:
        with profiling.annotate("model.block0"):
            torch.ones(2) + 1
    assert profiling.annotate("train.step") is first


def test_trace_holds_the_annotated_span(tmp_path):
    with profiling.trace(tmp_path / "t"):
        with profiling.annotate("aasist_batch"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aasist_batch" in names
    assert any(n and "mm" in n for n in names)


def test_trace_warm_up_grows_with_the_processes_age():
    """A window's warm-up lasts 1 ms plus 1e-4 s a second of the process's
    age, at most 0.1 s: some 20 times the 0.9 ms of launches an H100 lost
    at 175 s of age, and never seconds of waiting in an old process."""
    assert profiling.warm_up_s(0.0) == pytest.approx(1e-3)
    assert profiling.warm_up_s(175.0) > 20 * 0.9e-3
    assert profiling.warm_up_s(990.0) == pytest.approx(0.1)
    assert profiling.warm_up_s(10 * 3600.0) == profiling.WARM_UP_MAX_S == 0.1


def test_trace_warms_up_only_the_bodys_cards(monkeypatch):
    """The current card by default, else each card named once; a CPU
    device names none."""
    monkeypatch.setattr(profiling.torch.cuda, "current_device", lambda: 2)
    cuda = profiling.torch.device
    assert profiling._cards(None) == [cuda("cuda", 2)]
    assert profiling._cards(["cuda:0", "cuda:0", "cpu", "cuda"]) == [
        cuda("cuda", 0), cuda("cuda", 2)]
    assert profiling._cards(["cpu"]) == []


def _trace_file(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_read_trace_counts_the_bodys_kernels(tmp_path):
    """The body starts where the warm-up span ends; a launch call with no
    kernel event is an orphan (the warm-up's), a kernel's start less its
    call's is the skew."""
    events = [
        {"name": "PyTorch Profiler (0)", "ph": "X", "ts": 100, "dur": 900},
        {"name": profiling.WARM_UP_SPAN, "ph": "X", "ts": 110, "dur": 90},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 150,
         "args": {"correlation": 1}},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 300,
         "args": {"correlation": 2}},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 400,
         "args": {"correlation": 3}},
        {"name": "my_kernel<float>", "cat": "kernel", "ts": 310,
         "args": {"correlation": 2}},
        {"name": "my_kernel<float>", "cat": "kernel", "ts": 405,
         "args": {"correlation": 3}},
    ]
    assert profiling.body_window_us(events) == (200.0, 1000.0)
    res = profiling.read_trace(_trace_file(tmp_path, events), "my_kernel", 2)
    assert res["found"] == 2 and res["launches"] == 2
    assert res["starts_us"] == [110.0, 205.0]
    assert res["body_us"] == 800.0
    assert res["n_orphans"] == 1 and res["orphans_us"] == [-50.0]
    assert res["skew_us"] == [5.0, 10.0]
    assert res["launch_calls"] == {"cudaLaunchKernel": 3}


def test_body_window_without_a_warm_up_is_the_window(tmp_path):
    events = [{"name": "PyTorch Profiler (0)", "ph": "X", "ts": 5,
               "dur": 20}]
    assert profiling.body_window_us(events) == (5.0, 25.0)


def test_trace_warm_up_is_skipped_without_a_card(tmp_path, monkeypatch):
    """On the CPU the window holds only the body: no warm-up span."""
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: False)
    with profiling.trace(tmp_path / "t"):
        torch.ones(4) + 1
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert profiling.WARM_UP_SPAN not in names


def test_process_age_is_the_processes_life():
    age = profiling.process_age_s()
    assert 0.0 <= age < 7 * 24 * 3600
    assert profiling.process_age_s() >= age


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
