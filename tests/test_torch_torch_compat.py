"""The reference state-dict converter (``utils/torch_compat.py``) and the
``.npz`` writer (``weights.save_npz``) of the PyTorch port, on the CPU.

The goldens' seeded reference state dicts (``sd__*``: the one-element
``nn.Sequential`` wrappers and ``num_batches_tracked`` counters of the
reference's own ``state_dict``) land where the JAX package's
``fill_from_state_dict`` puts them; loading is strict both ways; a ``.pth``
round-trips through ``torch.save``; the written ``.npz`` is read back by
the port's ``load_npz`` and the JAX package's ``load_tree_npz``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from aasist_tpu.registry import build_model as jax_build_model
from aasist_tpu.utils import pytree_io as jax_io
from aasist_tpu.utils.torch_compat import (
    fill_from_state_dict as jax_fill_from_state_dict)

from aasist_tpu_torch import cli
from aasist_tpu_torch.config import load_config
from aasist_tpu_torch.registry import build_model
from aasist_tpu_torch.utils.torch_compat import (convert_checkpoint,
                                                 fill_from_state_dict)
from aasist_tpu_torch.weights import jax_trees, load_npz, save_npz

ROOT = Path(__file__).resolve().parent.parent
GOLDENS = ROOT / "tests" / "goldens"
WRAPPED = re.compile(r"^(encoder(?:_[ST])?\.\d+|block\d+)\.0\.")
ZOO = {"aasist2": "AASIST2", "rawgatst": "RawGATST_baseline",
       "rawnet2": "RawNet2_baseline"}


def _golden_sd(name):
    data = np.load(GOLDENS / f"{name}_golden.npz")
    return {k[len("sd__"):]: data[k] for k in data.files
            if k.startswith("sd__")}


def _model(conf):
    return build_model(load_config(conf).model_config)


def _reference_sd(model):
    """``model``'s weights under the reference's names: each encoder block
    wrapped in ``.0.``, BatchNorm counters kept."""
    return {re.sub(r"^(encoder(?:_[ST])?\.\d+|block\d+)\.", r"\1.0.", k):
            v.clone() for k, v in model.state_dict().items()}


def _seeded_robust():
    torch.manual_seed(0)
    return _model("AASIST-Robust")


def _equal_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_state_dict_lands_where_the_jax_package_puts_it(name):
    """The wrappers stripped, the counters dropped, every other tensor on
    the JAX package's leaf of the same path."""
    sd = _golden_sd(name)
    assert any(WRAPPED.match(k) for k in sd)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    model = fill_from_state_dict(_model(ZOO[name]), sd)
    jm = jax_build_model(load_config(ZOO[name]).model_config)
    zeros = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    want = [jax_io.flatten_tree(jax.tree_util.tree_map(np.asarray, t))
            for t in jax_fill_from_state_dict(*zeros, sd)]
    got = [jax_io.flatten_tree(t) for t in jax_trees(model)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_loading_is_strict_both_ways():
    sd = _golden_sd("rawgatst")
    model = _model("RawGATST_baseline")
    with pytest.raises(KeyError, match="stray"):
        fill_from_state_dict(model, {**sd, "stray.weight": np.zeros(3)})
    fill_from_state_dict(model, {**sd, "stray.weight": np.zeros(3)},
                         strict=False)
    with pytest.raises(ValueError, match="shape mismatch.*proj_T.weight"):
        fill_from_state_dict(model, {**sd, "proj_T.weight": np.zeros(
            (12, 13), np.float32)})
    partial = {k: v for k, v in sd.items()
               if not k.startswith("GAT_layer_ST.")}
    with pytest.raises(ValueError, match=r"random initialisation \(11\).*"
                       "GAT_layer_ST.att_proj.bias"):
        fill_from_state_dict(model, partial)
    fill_from_state_dict(model, partial, allow_unfilled=["GAT_layer_ST"])
    # a prefix is a whole dotted component, not a string prefix
    with pytest.raises(ValueError, match="GAT_layer_ST"):
        fill_from_state_dict(model, partial, allow_unfilled=["GAT_layer_S"])


@pytest.mark.parametrize("head", ["spk_cond_gat", "denoising"])
def test_a_head_the_checkpoint_lacks_raises(head):
    """AASIST2's speaker conditioning and AASIST-Robust's denoising block
    are in the model's tree though no eval forward of a plain input reads
    them: a checkpoint without them leaves them at their random init."""
    if head == "spk_cond_gat":
        model, sd = _model("AASIST2"), _golden_sd("aasist2")
    else:
        model = _model("AASIST-Robust")
        sd = _reference_sd(_seeded_robust())
    partial = {k: v for k, v in sd.items() if not k.startswith(head + ".")}
    assert len(partial) < len(sd)
    with pytest.raises(ValueError, match=head):
        fill_from_state_dict(model, partial)
    fill_from_state_dict(model, partial, allow_unfilled=[head])


def test_pth_round_trip(tmp_path):
    """torch.save of a reference-style state dict -> cli.load_model_weights
    (the --eval path) and convert_checkpoint's .npz -> load_npz: the same
    weights."""
    src = _seeded_robust()
    torch.save(_reference_sd(src), tmp_path / "robust.pth")
    via_cli = _model("AASIST-Robust")
    cli.load_model_weights(via_cli, tmp_path / "robust.pth")
    _equal_weights(via_cli, src)
    convert_checkpoint(_model("AASIST-Robust"), tmp_path / "robust.pth",
                       tmp_path / "robust.npz")
    _equal_weights(load_npz(_model("AASIST-Robust"),
                            tmp_path / "robust.npz"), src)
    with pytest.raises(ValueError, match="unsupported"):
        cli.load_model_weights(via_cli, tmp_path / "robust.ckpt")


@pytest.mark.parametrize("arch", ["AASIST", "AASIST2", "AASIST-Robust",
                                  "RawGATST", "RawNet2"])
def test_npz_writer(arch, tmp_path):
    """``save_npz`` in the layout of checkpoints/*.npz (AASIST: the same
    file as checkpoints/AASIST.npz, key for key), read back by the port's
    ``load_npz`` and, but for AASIST2, by the JAX package's
    ``load_tree_npz``: its reader makes a list of every node whose keys are
    digits and asks for 0 .. n-1, which SE's ``fc/0`` and ``fc/2`` are
    not, so it cannot read an AASIST2 tree, its own included."""
    if arch == "AASIST":
        model = load_npz(_model("AASIST"), ROOT / "checkpoints" / "AASIST.npz")
        conf = "AASIST"
    elif arch == "AASIST-Robust":
        model, conf = _seeded_robust(), "AASIST-Robust"
    else:
        name = {"AASIST2": "aasist2", "RawGATST": "rawgatst",
                "RawNet2": "rawnet2"}[arch]
        conf = ZOO[name]
        model = fill_from_state_dict(_model(conf), _golden_sd(name))
    path = tmp_path / "w.npz"
    save_npz(model, path)
    _equal_weights(load_npz(_model(conf), path), model)
    with np.load(path) as f:
        written = {k: f[k] for k in f.files}
    if arch == "AASIST":
        with np.load(ROOT / "checkpoints" / "AASIST.npz") as f:
            assert sorted(f.files) == sorted(written)
            for k in f.files:
                np.testing.assert_array_equal(written[k], f[k], err_msg=k)
    if arch == "AASIST2":
        return
    params, state = jax_io.load_tree_npz(path)
    read = {**{"params/" + k: v for k, v in
               jax_io.flatten_tree(params).items()},
            **{"state/" + k: v for k, v in
               jax_io.flatten_tree(state).items()}}
    assert read.keys() == written.keys()
    for k, v in written.items():
        np.testing.assert_array_equal(read[k], v, err_msg=k)
