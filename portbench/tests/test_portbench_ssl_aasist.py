"""The ``ssl-aasist`` configuration's yardstick and reference: its stored
FLOP count against ``FlopCounterMode`` on the benchmark's reference (at the
published widths, shapes only, on the meta device), that reference against
the repo's own (``tests/ssl_aasist_reference.py``) on seeded weights at a
small size, its names against the program's, the attention's roofline
reader, a whole small cell on the CPU: sound, and the fp8 control not;
and, on the card at the cell's widths and stand-in weights, graph pools
that keep node sets which vary by utterance."""

import importlib.util
import json
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.lib import compare, roofline, spec, traffic, weights
from portbench.lib import trace as tr
from portbench.lib.run import execute
from portbench.lib.score import build_program, load_program_model
from portbench.reference import ssl_aasist as ref
from portbench.tests import cells as C
from portbench.tests.cells import HARNESS, REPO

CONF = json.loads((HARNESS / "configs" / "ssl-aasist.json").read_text())
SMALL = {**CONF["model_config"],
         "conv_feature_layers": [[32, 10, 5]] + [[32, 3, 2]] * 4
         + [[32, 2, 2]] * 2,
         "encoder_embed_dim": 64, "encoder_layers": 2,
         "encoder_attention_heads": 4, "encoder_ffn_embed_dim": 128,
         "conv_pos": 16, "conv_pos_groups": 4}
SEED = 2**31 + 303


def _load(path, name):
    spec_ = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


def test_stored_flops_are_the_reference_count():
    """Two utterances on the meta device, halved, as ``lib/flops.py``
    counts AASIST's (that file is tied to the AASIST reference)."""
    mc = CONF["model_config"]
    P = {n: torch.empty(s, device="meta")
         for n, (s, _) in ref.param_shapes(mc).items()}
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        ref.forward(P, torch.empty(2, 64600, device="meta"), mc)
    want = counter.get_total_flops() // 2
    assert CONF["flops"]["forward@64600"] == want
    assert abs(want / 1e9 - 150.2) < 0.1


def test_the_names_are_the_programs():
    mc = CONF["model_config"]
    with torch.device("meta"):
        from aasist_tpu_torch.registry import build_model
        model = build_model(mc)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == {k: s for k, (s, _) in ref.param_shapes(mc).items()}


def test_seeded_weights_fill_the_program_model():
    P = weights.make(ref, SMALL, SEED, "cpu")
    model = load_program_model(SMALL, P)
    got = model.state_dict()
    assert all(torch.equal(got[n], P[n]) for n in P)


def test_the_benchmark_copy_is_the_repo_reference():
    repo_ref = _load(REPO / "tests" / "ssl_aasist_reference.py",
                     "ssl_aasist_reference")
    P = weights.make(ref, SMALL, SEED, "cpu")
    x = torch.from_numpy((np.random.default_rng(5).standard_normal(
        (3, 8000)) * 0.1).astype(np.float32))
    with torch.no_grad():
        hidden, logits = ref.forward(P, x, SMALL)
    want_hidden, want_logits = repo_ref.forward(P, x, SMALL)
    # two float32 writings of the same mathematics (F.layer_norm and
    # F.gelu against the written-out formulas): round-off of ~1e-6 grown
    # through 26 layers; a misplaced term moves logits by ~1e-1
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(hidden.numpy(), want_hidden.numpy(),
                               atol=1e-3, rtol=0)


READER = HARNESS / "metrics" / "attention_roofline.score.py"


def test_the_attention_bound_at_the_cells_shapes():
    m = _load(READER, "attention_roofline_score")
    mc, serve = CONF["model_config"], CONF["serve"]
    s = m.frames(mc["conv_feature_layers"], serve["window"])
    ms, what = m.bound_ms(serve["batch_size"], s, mc["encoder_embed_dim"],
                          mc["encoder_layers"], serve["dtype"], roofline)
    assert s == 201 and what == "bytes" and round(ms, 2) == 1.51
    # by operations alone: 0.51 ms
    flops = 24 * 4.0 * 128 * 201 ** 2 * 1024
    assert round(flops / roofline.PEAK_FLOPS["bfloat16"] * 1e3, 2) == 0.51


def _ctx(ops, batches):
    ms = 1_000_000
    trace = tr.Trace(0, 100 * ms, ops, [("portbench.call", 0, 100 * ms)])
    return types.SimpleNamespace(
        config=CONF, traffic={}, trace=trace, counts={"batches": batches},
        host={}, roofline=roofline)


def test_the_reader_reads_the_fused_kernels():
    m = _load(READER, "attention_roofline_score")
    ms = 1_000_000
    plain = [("sm90_xmma_gemm_bf16bf16", 0, 10 * ms),
             ("void at::native::vectorized_elementwise_kernel", 10 * ms,
              12 * ms)]
    assert m.read(_ctx(plain, 2)) is None
    assert m.read(_ctx(plain, 0)) is None
    # two batches, 3.02 ms of flash and 3.02 of cuDNN's kernels: 3.02 ms a
    # batch, twice the 1.51-ms bound
    fused = plain + [
        ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>",
         20 * ms, 23 * ms + 20_000),
        ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop", 30 * ms,
         33 * ms + 20_000)]
    assert m.read(_ctx(fused, 2)) == pytest.approx(50.0, rel=1e-3)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    conf = {**C.config(), "reference": "ssl_aasist", "model_config": SMALL}
    return C.make_checkout(tmp_path_factory.mktemp("ssl"), [
        ("ssl-score", "ssl-small", conf, "shards", C.SCORE_LIMITS)])


def test_a_sound_run_is_correct_and_the_fp8_control_is_not(checkout):
    torch.set_num_threads(2)
    cell = spec.load_cell(checkout, "ssl-score")
    out = execute(cell, SEED, 1.0, False, torch.device("cpu"), keep=True)
    ok, checks = compare.judge(out.readings, cell.limits)
    assert ok and out.failed == 0 and out.attempted > 0, checks
    kept = out.kept
    low = ref.score_rows(kept["P"], kept["rows"], SMALL, device="cpu",
                         block=4, q=ref.fp8)
    ok, checks = compare.judge(compare.score_readings(
        low, kept["reference"]), cell.limits)
    assert not ok, checks


# the graph pools, in the order the program and the reference call them
POOLS = ("pool_S", "pool_T", "pool_hS1", "pool_hT1", "pool_hS2", "pool_hT2")


def _kept(monkeypatch, forward):
    """{pool: the node set it kept for each utterance} in ``forward()``,
    from the indices of each ``torch.topk`` call (the pools' only)."""
    calls = []
    topk = torch.topk

    def recording(*args, **kw):
        out = topk(*args, **kw)
        calls.append([frozenset(r) for r in out.indices.tolist()])
        return out

    with monkeypatch.context() as m:
        m.setattr(torch, "topk", recording)
        forward()
    assert len(calls) == len(POOLS)
    return dict(zip(POOLS, calls))


def _off_the_mode(sets):
    """The share of utterances whose set is not the most common one."""
    return 1 - max(sets.count(s) for s in set(sets)) / len(sets)


def test_the_pools_keep_nodes_that_vary_by_utterance(monkeypatch):
    """The reference on the stand-in's weights at the small size: every
    pool keeps another node set for some utterances (at 16,000 samples,
    16 temporal nodes, so the last pools keep 4 of 8)."""
    P = weights.make(ref, SMALL, SEED, "cpu")
    rng = np.random.default_rng(6)
    x = torch.from_numpy((rng.standard_normal((16, 16000))
                          * rng.uniform(0.01, 0.3, (16, 1)))
                         .astype(np.float32))
    with torch.no_grad():
        kept = _kept(monkeypatch, lambda: ref.forward(P, x, SMALL))
    assert all(_off_the_mode(kept[p]) > 0 for p in POOLS), {
        p: _off_the_mode(kept[p]) for p in POOLS}


@pytest.mark.chip
def test_the_cells_pools_keep_nodes_that_vary_by_utterance(card,
                                                           monkeypatch):
    """``ssl-aasist-score-b128`` at its widths, its seed-0 weights (the
    pools' projections at the biases' scale) and a batch of its
    utterances: in the bf16 program and in the f32 reference every pool
    keeps other node sets for some utterances, so pooling still shapes the
    scores the check compares; prints the shares off each pool's most
    common set, the share of utterances whose set the program and the
    reference agree on, and the mean share of a set they share."""
    cell = spec.load_cell(REPO, "ssl-aasist-score-b128")
    mc, serve = cell.config["model_config"], cell.config["serve"]
    P = weights.of_config(serve["weights"], ref, mc, SEED, card, REPO)
    waves = traffic.make_pool(cell.traffic, SEED, card)
    rows = torch.from_numpy(np.stack([
        ref.crop_or_tile(w, serve["window"])
        for w in waves[:serve["batch_size"]]])).to(card)
    model = build_program(cell, P, card).model
    with torch.inference_mode():
        program = _kept(monkeypatch, lambda: model(rows))
    del model
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            reference = _kept(monkeypatch, lambda: ref.forward(P, rows, mc))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    readings = {p: {"program_off_mode": _off_the_mode(program[p]),
                    "reference_off_mode": _off_the_mode(reference[p]),
                    "agree": float(np.mean([a == b for a, b in zip(
                        program[p], reference[p])])),
                    "overlap": float(np.mean([len(a & b) / len(a) for a, b
                                              in zip(program[p],
                                                     reference[p])]))}
                for p in POOLS}
    print(json.dumps(readings, sort_keys=True))
    assert all(r["program_off_mode"] > 0 and r["reference_off_mode"] > 0
               for r in readings.values()), readings
