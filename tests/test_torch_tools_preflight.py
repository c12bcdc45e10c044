"""The port's LA preflight (``aasist_tpu_torch/tools/preflight_la``) against
the JAX tool (``tools/preflight_la.py``) on the CPU.

The cases of ``tests/test_preflight_la.py`` (a good synthetic corpus, an
eval utterance's audio removed, the dev protocol removed, the ASV score file
removed) and a few more broken layouts: both tools print the same ``ok`` and
``FAIL`` lines and return the same exit code, and the port prints its own
parity command.  Each call of the port's tool reports its own problems.
"""

import contextlib
import importlib.util
import io
import os
import shutil
import sys
from pathlib import Path

import pytest

from aasist_tpu_torch.data import synthetic
from aasist_tpu_torch.tools import preflight_la

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("pf") / "LA"
    synthetic.generate(root, n_train=4, n_dev=4, n_eval=8, seed=31)
    return root


def _jax_main(root):
    """(exit code, printed lines) of tools/preflight_la.py on ``root``, run
    in this process (its problems list is module-global: a fresh module a
    call)."""
    spec = importlib.util.spec_from_file_location(
        "jax_preflight_la", ROOT / "tools" / "preflight_la.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out, argv = io.StringIO(), sys.argv
    sys.argv = ["preflight_la.py", str(root)]
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main()
    finally:
        sys.argv = argv
    return rc, out.getvalue().splitlines()


def _port_main(root):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = preflight_la.main([str(root)])
    return rc, out.getvalue().splitlines()


def _checks(lines):
    """The check lines and the verdict line, without the printed
    command."""
    return [ln for ln in lines if ln.startswith(("ok   ", "FAIL ",
                                                 "preflight "))]


def _rm(rel):
    return lambda root: os.remove(root / rel)


def _rm_first_eval_flac(root):
    flac = root / "ASVspoof2019_LA_eval" / "flac"
    os.remove(flac / sorted(os.listdir(flac))[0])


def _one_class_dev(root):
    proto = (root / "ASVspoof2019_LA_cm_protocols"
             / "ASVspoof2019.LA.cm.dev.trl.txt")
    lines = proto.read_text().splitlines()
    proto.write_text("".join(ln + "\n" for ln in lines
                             if ln.endswith("spoof")))


def _asv_without_spoof(root):
    path = root / preflight_la.ASV_SCORES
    lines = path.read_text().splitlines()
    path.write_text("".join(ln + "\n" for ln in lines if " spoof " not in ln))


CASES = {
    "valid": None,
    "missing_audio": _rm_first_eval_flac,
    "missing_protocol": _rm("ASVspoof2019_LA_cm_protocols/"
                            "ASVspoof2019.LA.cm.dev.trl.txt"),
    "missing_asv_scores": _rm(preflight_la.ASV_SCORES),
    "missing_audio_dir": lambda root: shutil.rmtree(
        root / "ASVspoof2019_LA_train" / "flac"),
    "one_class": _one_class_dev,
    "asv_lacks_a_class": _asv_without_spoof,
    "not_a_directory": lambda root: shutil.rmtree(root),
}
WANT = {"valid": None, "missing_audio": "missing audio",
        "missing_protocol": "protocol missing",
        "missing_asv_scores": "ASV score file missing",
        "missing_audio_dir": "audio dir missing",
        "one_class": "need both classes",
        "asv_lacks_a_class": "ASV score file lacks classes",
        "not_a_directory": "not a directory"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preflight_matches_the_jax_tool(case, corpus, tmp_path):
    root = tmp_path / "LA"
    shutil.copytree(corpus, root)
    if CASES[case]:
        CASES[case](root)
    rc, lines = _port_main(root)
    j_rc, j_lines = _jax_main(root)
    print("\n".join(lines))
    assert rc == j_rc == (0 if case == "valid" else 1)
    assert _checks(lines) == _checks(j_lines)
    fails = [ln for ln in lines if ln.startswith("FAIL ")]
    if case == "valid":
        assert not fails
        assert ("    python -m aasist_tpu_torch.tools.verify_reference_parity"
                f" --database_path {root}") in lines
        for split in ("train", "dev", "eval"):
            assert any(ln.startswith(f"ok   {split}: decoded")
                       for ln in lines)
    else:
        assert fails and all(WANT[case] in ln for ln in fails[:1])
        assert not any("verify_reference_parity" in ln for ln in lines)


def test_each_call_reports_its_own_problems(corpus, tmp_path):
    """The JAX tool keeps its problems in a module-global list; the port's
    ``preflight`` returns each call's own, so a broken layout's problems do
    not carry into the next call."""
    broken = tmp_path / "LA"
    shutil.copytree(corpus, broken)
    _rm(preflight_la.ASV_SCORES)(broken)
    lines = []
    assert len(preflight_la.preflight(str(broken), out=lines.append)) == 1
    assert preflight_la.preflight(str(corpus), sample=2,
                                  out=lines.append) == []
    assert "ok   eval: audio present for first 2 protocol utterances" \
        in lines
