"""The port's host-side measuring tools on the CPU: ``bench_loader`` (the
eval batcher's utt/s) and ``bench_decode`` (the FLAC decoder's ms a file)
on a tiny synthetic FLAC corpus, one rep each; and every new tool that
takes ``--device`` raises without a card when the device is left at its
default."""

import contextlib
import io
import re

import pytest
import torch

from aasist_tpu_torch.data import synthetic
from aasist_tpu_torch.tools import (bench_decode, bench_loader,
                                    profile_stages, verify_reference_parity)

N_EVAL = 6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench") / "LA"
    synthetic.generate(root, n_train=1, n_dev=1, n_eval=N_EVAL, seed=13,
                       max_duration_s=2.0)
    return root


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def test_bench_loader_on_the_cpu(corpus):
    lines = _lines(bench_loader.main, [str(corpus), "4", "1", "--device",
                                       "cpu"])
    print(lines)
    assert len(lines) == 1
    assert re.fullmatch(rf"\d+ utt/s host-side \({N_EVAL} utts x 1 reps, "
                        r"batch 4, best of 3\)", lines[0])


def test_bench_decode(corpus):
    lines = _lines(bench_decode.main, [
        str(corpus / "ASVspoof2019_LA_eval" / "flac"), "1"])
    print(lines)
    assert len(lines) == 1
    assert re.fullmatch(rf"\d+\.\d{{3}} ms/file  \d+ files/s/core "
                        rf"\({N_EVAL} files x 1 reps, best of 5\)", lines[0])


def test_empty_directories_exit(tmp_path):
    with pytest.raises(SystemExit, match="no .flac"):
        bench_decode.main([str(tmp_path)])
    (tmp_path / "ASVspoof2019_LA_eval" / "flac").mkdir(parents=True)
    with pytest.raises(SystemExit, match="no .flac"):
        bench_loader.main([str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("main, argv", [
    (verify_reference_parity.main, []),
    (profile_stages.main, ["2"]),
    (bench_loader.main, ["LA"]),
], ids=["verify_reference_parity", "profile_stages", "bench_loader"])
def test_tools_default_to_cuda_and_raise_without_it(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
