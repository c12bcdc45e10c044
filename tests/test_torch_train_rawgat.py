"""The port's train step against the JAX package's for RawGAT-ST, float64,
on the CPU, as ``tests/test_torch_train_models.py`` holds AASIST (its
docstring says how): two Adam steps at 64,600 samples (its projections fix
the node counts) on narrow encoders."""

from test_torch_train_models import _run, one_torch_thread  # noqa: F401
from test_torch_train_zoo import no_grad_leaves


def test_rawgat_train_steps_match_jax():
    assert (_run("RawNetGatSpoofST", "adam")
            == no_grad_leaves("RawNetGatSpoofST"))
