"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``chip`` marker for tests that need a CUDA card, which decide on one
inside the ``card`` fixture and skip without it."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one); run on the "
        "card with `python3 -m pytest portbench/tests -m chip`")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)
