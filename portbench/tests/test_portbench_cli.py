"""The entry point's failures: an unknown workload, no card, no program;
each exits non-zero and prints no result line."""

import shutil
import subprocess
import sys

from portbench.tests.cells import REPO


def _run(cwd, code):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


MAIN = ("import sys; from portbench.run import main; "
        "sys.exit(main(['--workload', {w!r}, '--seed', '1', '--seconds', "
        "'1']))")


def test_unknown_workload():
    res = _run(REPO, MAIN.format(w="no-such-cell"))
    assert res.returncode == 2 and res.stdout == ""
    assert "unknown workload" in res.stderr


def test_no_card():
    res = _run(REPO, "import torch; torch.cuda.is_available = lambda: "
               "False; " + MAIN.format(w="aasist-score-b128"))
    assert res.returncode == 1 and res.stdout == ""


def test_only_the_benchmark_files(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path, "import torch; torch.cuda.is_available = lambda: "
               "True; torch.cuda.device_count = lambda: 1; "
               + MAIN.format(w="aasist-score-b128"))
    assert res.returncode != 0 and res.stdout == ""
    assert "aasist_tpu_torch" in res.stderr
