"""The plain reference against the repo's goldens (read only), and its
checkpoint reader against the configuration's shapes."""

import json
import re

import numpy as np
import pytest
import torch

from portbench.lib import weights
from portbench.reference import aasist as ref
from portbench.tests.cells import HARNESS, REPO

GOLDENS = REPO / "tests" / "goldens"


def _mc(name):
    return json.loads((HARNESS / "configs" / f"{name}.json").read_text()
                      )["model_config"]


def _forward(P, x, mc):
    bank = torch.from_numpy(ref.sinc_bank(mc["filts"][0], mc["first_conv"]))
    with torch.no_grad():
        return [t.numpy() for t in ref.forward(P, torch.from_numpy(x), mc,
                                               bank)]


def test_aasist_pretrained_matches_the_golden():
    mc = _mc("aasist")
    P = weights.load_checkpoint(REPO / "checkpoints" / "AASIST.npz", "cpu")
    assert {k: tuple(v.shape) for k, v in P.items()} == {
        k: s for k, (s, _) in ref.param_shapes(mc).items()}
    g = np.load(GOLDENS / "aasist_golden.npz")
    hidden, logits = _forward(P, g["x"], mc)
    np.testing.assert_allclose(logits, g["logits"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(hidden, g["hidden"], atol=1e-4, rtol=0)


def test_aasist2_matches_the_golden():
    mc = _mc("aasist2")
    g = np.load(GOLDENS / "aasist2_golden.npz")
    P = {}
    for k in g.files:
        name = re.sub(r"^(encoder\.\d+)\.0\.", r"\1.", k[len("sd__"):])
        if (k.startswith("sd__") and not name.startswith("spk_cond_gat")
                and not name.endswith("num_batches_tracked")):
            P[name] = torch.from_numpy(np.array(g[k]))
    assert set(P) == set(ref.param_shapes(mc))
    hidden, logits = _forward(P, g["x"], mc)
    np.testing.assert_allclose(logits, g["logits"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(hidden, g["hidden"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["aasist", "aasist2"])
def test_seeded_weights_fill_the_program_model(name):
    from portbench.lib.score import load_program_model
    mc = _mc(name)
    P = weights.make(ref, mc, 2**31 + 11, "cpu")
    model = load_program_model(mc, P)
    got = dict(model.named_parameters())
    assert all(torch.equal(got[n], P[n]) for n in got)
    again = weights.make(ref, mc, 2**31 + 11, "cpu")
    assert all(torch.equal(P[n], again[n]) for n in P)


def test_fp8_rounds_onto_the_scale():
    t = torch.linspace(-3, 3, 1001)
    q = ref.fp8(t)
    assert q.abs().max() == pytest.approx(3.0)
    err = (q - t).abs().max().item()
    assert 1e-3 < err < 0.2
