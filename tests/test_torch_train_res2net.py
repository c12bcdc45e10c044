"""The port's train step against the JAX package's for AASIST2's Res2Net
encoder, float64, on the CPU, as ``tests/test_torch_train_models.py``
holds AASIST (its docstring says how): two Adam steps of a narrow AASIST2
(four splits, the carry at split 2)."""

from test_torch_train_models import _run, one_torch_thread  # noqa: F401


def test_res2net_train_steps_match_jax():
    """Every leaf gets a gradient: the Res2Net block consumes its bn1."""
    assert _run("AASIST2", "adam") == set()
