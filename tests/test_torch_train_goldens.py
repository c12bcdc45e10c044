"""The port's training math against the PyTorch reference's float64 train
goldens (``tests/goldens/train_diff_*.npz``), on the CPU, through
``aasist_tpu_torch/tools/train_golden.py`` (which ``chip_smoke.py`` runs on
the card): the four lr schedules at 1e-12, and RawNet2's gradients,
BatchNorm statistics and two Adam steps at 1e-8, the gates of
``tools/check_train_differential.py``.  The full-width AASIST (three
losses), AASIST2 (ALMFT, the speaker embedding) and RawGAT-ST goldens take
minutes on the CPU: ``-m slow``."""

import pytest
import torch

from aasist_tpu_torch.tools import train_golden

from test_torch_train_models import one_torch_thread  # noqa: F401


def _assert_within(readings):
    bad = [(label, d, where) for label, d, where, gate in readings
           if not d <= gate]
    assert not bad, bad
    return {label for label, *_ in readings}


@pytest.mark.parametrize("schedule", ["cosine", "keras_decay", "multistep",
                                      "sgdr"])
def test_lr_schedule_matches_the_reference(schedule):
    readings = [r for r in train_golden.check_lr()
                if r[0] == f"lr {schedule}"]
    assert len(readings) == 1
    _assert_within(readings)


def test_rawnet2_train_golden():
    labels = _assert_within(train_golden.check_model("rawnet2",
                                                     device="cpu"))
    assert {"rawnet2 grads_cce", "rawnet2 bnstats_cce",
            "rawnet2 adam_state2"} <= labels


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_point_runs_on_the_card_by_default():
    """Without ``--device cpu`` the entry point asks for the card, and
    raises without one, as the CLI does."""
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_golden.main(["rawnet2"])


@pytest.mark.slow
@pytest.mark.parametrize("name", ["aasist", "aasist2", "rawgatst"])
def test_full_width_train_golden(name):
    labels = _assert_within(train_golden.check_model(name, device="cpu"))
    assert f"{name} adam_state2" in labels
