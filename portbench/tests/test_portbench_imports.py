"""Nothing of the benchmark imports JAX, the JAX package or
``chip_smoke``, compared by whole top-level module name; the plain
reference imports nothing of the program either."""

import ast

from portbench.run import FORBIDDEN, forbidden_modules
from portbench.tests.cells import HARNESS


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(HARNESS.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = _top_level_imports(path) & {*FORBIDDEN, "chip_smoke"}
        assert not bad, f"{path}: {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (HARNESS / "reference").glob("*.py"):
        names = _top_level_imports(path)
        assert not names & {"aasist_tpu_torch", *FORBIDDEN}, path


def test_whole_names_are_compared():
    assert forbidden_modules(["aasist_tpu_torch", "aasist_tpu_torch.ops",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "aasist_tpu.models",
                              "flax"]) == ["aasist_tpu", "flax", "jax"]
