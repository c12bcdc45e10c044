"""The plain version of the chained-dot kernels (``aasist_tpu_torch/ops/
mma_shapes``) against ``tools/probe_mxu_shapes.py``, on the CPU.

The probe calls ``pl.pallas_call`` without ``interpret``; the tests patch it
to interpret mode, with nothing in ``tools/`` changed.  Its kernel fixes eps
at 1e-30, where the bf16 add leaves a unchanged at inputs of order one, so
its ``run`` is held against ``mma_chain_reference`` with w scaled until the
update shows; a ``jax.numpy`` statement of ``_kernel``'s loop, written
here, is a second witness at the visible eps of the card's check
(``tools/_common.py:mma_eps``).  Both under the card's gates
(``mma_readings``).  w and a come from numpy seeds, rounded to bf16 once
and handed to both sides as the same values.  ``mma_chain`` (on
``csrc/mma_chain_wg.cu``) and ``mma_chain_older`` (``csrc/mma_shapes.cu``)
take the same plain version on the CPU: the JAX comparisons run once, and
one test asserts that both names dispatch to it.  The ``wgmma`` kernel
cannot run here, so a numpy model of its maps (the packed operands read
through their descriptors, the accumulator layout, the sums over a quad and
over a cluster's ranks, the update of row 0) runs a few dots against the
plain version; its constants come from the source.
"""

import functools
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from aasist_tpu_torch.ops import _build
from aasist_tpu_torch.ops import mma_shapes as ms
from aasist_tpu_torch.tools import _common

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools"))
import probe_mxu_shapes as PM  # noqa: E402


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


def _inputs(seed, k, m, n_cols=ms.N_COLS):
    """(w, a) as torch bf16 tensors and as the same jax bf16 arrays."""
    r = np.random.default_rng(seed)
    w = torch.from_numpy(r.normal(0, 1, (k, m)).astype(np.float32))
    a = torch.from_numpy(r.normal(0, 1, (k, n_cols)).astype(np.float32))
    w, a = w.bfloat16(), a.bfloat16()
    return (w, a, jnp.asarray(w.float().numpy(), jnp.bfloat16),
            jnp.asarray(a.float().numpy(), jnp.bfloat16))


def _jnp_chain(w, a, n, eps):
    """``tools/probe_mxu_shapes.py:_kernel``'s loop in jax.numpy, with eps
    a parameter: the whole operand after n dots."""
    def body(_, a_scr):
        y = lax.dot_general(w, a_scr, (((0,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
        s = jnp.sum(y * y, axis=0, keepdims=True) * eps
        return a_scr.at[0:1, :].set(a_scr[0:1, :] + s.astype(a_scr.dtype))
    return lax.fori_loop(0, n, body, a)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", ["k12_m192", "k132_m210", "k192_m32"])
def test_reference_matches_probe_run(interpret_pallas, name, n):
    """At the probe's own eps of 1e-30 the update shows when w is scaled
    instead: w ~ N(0, 1) sqrt(4e30 / (K M)) gives 1e-30 sum_m y^2 ~ 4 a
    dot, with y^2 far inside the f32 range.  The probe's (8, 128) output
    is held to the plain version under the card's gates (rows 1..7
    exact)."""
    k, m = ms.SHAPES[name]
    w, a, _, aj = _inputs(1, k, m)
    w = (w.float() * (4e30 / (k * m)) ** 0.5).bfloat16()
    wj = jnp.asarray(w.float().numpy(), jnp.bfloat16)
    want = torch.from_numpy(np.array(PM.run(wj, aj, n, m))).bfloat16()
    got = ms.mma_chain(w, a, n)            # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == a.shape
    assert torch.equal(want[1:], a[1:8, 0:128])
    text, fails = _common.mma_readings(name, got[0:8, 0:128], want,
                                       a[0:8, 0:128])
    assert not fails, text


@pytest.mark.parametrize("name", list(ms.SHAPES))
def test_reference_matches_jnp_loop_at_a_visible_eps(name):
    """At the card check's eps the update moves every column's row 0; the
    plain version meets the jnp loop under the card's gates (both sum y^2 in
    f32, in their own orders), and the planted fault (a K row of w zeroed)
    reads over the mean gate by the required factor."""
    k, m = ms.SHAPES[name]
    w, a, wj, aj = _inputs(2, k, m)
    eps, n = _common.mma_eps(k, m), _common.MMA_CHECK_ITERS
    want = torch.from_numpy(np.array(
        _jnp_chain(wj, aj, n, eps).astype(jnp.float32))).bfloat16()
    got = ms.mma_chain(w, a, n, eps)
    bad = _common.mma_bad(
        w, a, lambda ww, aa: ms.mma_chain_reference(ww, aa, n, eps))
    text, fails = _common.mma_readings(name, got, want, a, bad)
    assert not fails, text


def test_probe_eps_changes_nothing():
    """At the probe's 1e-30 the bf16 add leaves a as it was: its output is
    the input, whatever the dots give."""
    w, a, _, _ = _inputs(3, 96, 96, 64)
    torch.testing.assert_close(ms.mma_chain(w, a, 4), a, rtol=0, atol=0)


def test_shapes_are_the_probes():
    assert ms.SHAPES == PM.SHAPES and ms.N_COLS == PM.N_LANES
    assert ms.EPS == 1e-30


def test_every_shape_fits_shared_memory_and_a_build():
    """At every probe shape the ``wgmma`` kernel's plan (k-steps, n16 tiles
    of a CTA's slice of w at the shape's cluster size) is a build of the
    source and its operands fit a block's shared memory, as do the older
    kernel's w^T and 16-column slice (k144_m630 is the largest, 190 KB)
    with every K padding to a k-step count it is built for."""
    for name, (k, m) in ms.SHAPES.items():
        cl = ms.CLUSTER[name]
        assert cl in (1, 2) and ms.cluster_of(k, m) == cl
        assert ms.plan(k, m, cl) in ms.BUILDS
        assert ms.smem_bytes(k, m) <= ms.SMEM_PER_BLOCK
        assert ms.smem_bytes_older(k, m) <= ms.SMEM_PER_BLOCK
        assert -(-k // 16) in ms.K_STEPS
    assert ms.plan(144, 630, 2) == (9, 20) and ms.plan(12, 192, 1) == (1, 12)
    assert ms.smem_bytes(144, 630) == (144 * (320 + 64) * 2
                                       + 2 * 2 * 32 * 8 + 16)
    assert ms.smem_bytes_older(144, 630) == (640 + 16) * 152 * 2 + 8 * 16 * 4
    assert ms.padded(12, 192) == (16, 192) and ms.padded(132, 210) == (144,
                                                                      224)


def test_cpu_tensors_take_the_plain_version():
    w, a, _, _ = _inputs(4, 12, 192, 32)
    before = ms.mma_chain.launches
    torch.testing.assert_close(ms.mma_chain(w, a, 3, 1e-3),
                               ms.mma_chain_reference(w, a, 3, 1e-3), rtol=0,
                               atol=0)
    assert ms.mma_chain.launches == before


class _FakeCuda:
    """Stands in for a CUDA tensor in the guards, which read ``device``,
    ``dtype``, ``dim``, ``shape`` and ``is_contiguous`` before any
    launch."""

    def __init__(self, t, contiguous=True):
        self._t, self._c = t, contiguous
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._c


def test_cuda_call_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    w, a, _, _ = _inputs(5, 12, 192, 32)
    before = ms.mma_chain.launches
    with pytest.raises((RuntimeError, AssertionError)):
        ms.mma_chain(_FakeCuda(w), _FakeCuda(a), 2)
    assert ms.mma_chain.launches == before


GUARDS = [
    ("float32", dict(dtype=torch.float32), TypeError, "bfloat16"),
    ("a strided a", dict(contig=False), ValueError, "contiguous 2-D"),
    ("K of w and a differ", dict(a_rows=13), ValueError,
     "unsupported shapes"),
    ("K = 40 (3 k-steps)", dict(k=40), ValueError, "built for"),
    ("w^T over shared memory", dict(k=384, m=2000), ValueError,
     "shared memory"),
]


@pytest.mark.parametrize("what,kw,exc,match", GUARDS,
                         ids=[g[0] for g in GUARDS])
def test_guards_raise(what, kw, exc, match):
    k, m = kw.get("k", 12), kw.get("m", 192)
    dt = kw.get("dtype", torch.bfloat16)
    w = torch.zeros((k, m), dtype=dt)
    a = torch.zeros((kw.get("a_rows", k), 32), dtype=dt)
    with pytest.raises(exc, match=match):
        ms.mma_chain(_FakeCuda(w), _FakeCuda(a, kw.get("contig", True)), 2)


def test_bound_is_the_useful_flops():
    bound, by = _common.mma_chain_bound(128, 128, 2048)
    assert by == "operations"
    assert bound == pytest.approx(2 * 128 * 128 * 2048 / 989e12 * 1e3)


# ------------------------------------------- both wrappers, their builds
def test_both_wrappers_dispatch_to_the_plain_version(monkeypatch):
    """On CPU tensors ``mma_chain`` and ``mma_chain_older`` both return
    ``mma_chain_reference``'s result and count no launch: the JAX
    comparisons above hold for both."""
    calls = []

    def plain(w, a, n, eps=ms.EPS):
        calls.append((n, eps))
        return a
    monkeypatch.setattr(ms, "mma_chain_reference", plain)
    w, a, _, _ = _inputs(6, 12, 192, 32)
    for fn in (ms.mma_chain, ms.mma_chain_older):
        before = fn.launches
        assert fn(w, a, 3, 1e-3) is a and fn.launches == before
    assert calls == [(3, 1e-3), (3, 1e-3)]


class _Built(Exception):
    pass


@pytest.mark.parametrize("name,source", [("mma_chain", "mma_chain_wg"),
                                         ("mma_chain_older", "mma_shapes")])
def test_wrappers_launch_their_builds(monkeypatch, name, source):
    """``mma_chain`` asks for ``csrc/mma_chain_wg.cu``'s build and
    ``mma_chain_older`` for ``csrc/mma_shapes.cu``'s, and neither counts a
    launch when the build stops it."""
    seen = []

    def load(src, defines=None):
        seen.append((src, defines))
        raise _Built
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: None)
    w, a, _, _ = _inputs(7, 12, 192, 32)
    fn = getattr(ms, name)
    before = fn.launches
    with pytest.raises(_Built):
        fn(_FakeCuda(w), _FakeCuda(a), 2)
    assert seen == [(source, None)] and fn.launches == before


def test_cluster_is_a_constant_of_the_shape():
    """The cluster size is ``CLUSTER``'s at a probe shape and 1 at any
    other, with no argument to change it; a shape whose plan at that size
    is not built raises before any launch."""
    import inspect
    assert list(inspect.signature(ms.mma_chain).parameters) == [
        "w", "a", "n", "eps"]
    assert {ms.cluster_of(*shape) for shape in ms.SHAPES.values()} == {1, 2}
    assert ms.cluster_of(144, 630) == 2 and ms.cluster_of(12, 192) == 1
    assert ms.cluster_of(90, 90) == 1 and ms.cluster_of(130, 200) == 1
    for k, m in ((90, 300), (130, 200)):
        with pytest.raises(ValueError, match="built for"):
            ms.mma_chain(_FakeCuda(torch.zeros((k, m), dtype=torch.bfloat16)),
                         _FakeCuda(torch.zeros((k, 32), dtype=torch.bfloat16)),
                         2)


def test_older_cuda_call_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    w, a, _, _ = _inputs(9, 12, 192, 32)
    before = ms.mma_chain_older.launches
    with pytest.raises((RuntimeError, AssertionError)):
        ms.mma_chain_older(_FakeCuda(w), _FakeCuda(a), 2)
    assert ms.mma_chain_older.launches == before


OLDER_GUARDS = [
    ("float32", dict(dtype=torch.float32), TypeError, "bfloat16"),
    ("K = 40 (3 k-steps)", dict(k=40), ValueError, "built for"),
    ("w^T over shared memory", dict(k=384, m=640), ValueError,
     "shared memory"),
]


@pytest.mark.parametrize("what,kw,exc,match", OLDER_GUARDS,
                         ids=[g[0] for g in OLDER_GUARDS])
def test_older_guards_raise(what, kw, exc, match):
    k, m = kw.get("k", 12), kw.get("m", 192)
    dt = kw.get("dtype", torch.bfloat16)
    w = torch.zeros((k, m), dtype=dt)
    a = torch.zeros((k, 32), dtype=dt)
    with pytest.raises(exc, match=match):
        ms.mma_chain_older(_FakeCuda(w), _FakeCuda(a), 2)


# ------------------------------------ a numpy model of mma_chain_wg.cu
SRC = (_build.CSRC / "mma_chain_wg.cu").read_text()
KC = {m[1]: int(m[2]) for m in re.finditer(
    r"constexpr int (\w+) = (\d+);", SRC)}


def test_source_constants_are_the_wrappers():
    """The builds, widths and layout constants the wrapper states are the
    source's."""
    body = SRC[SRC.index("#define MCW_BUILDS(X)"):]
    body = body[:body.index("\n\n")]
    builds = tuple((int(a), int(b)) for a, b in re.findall(
        r"X\((\d+), (\d+)\)", body))
    assert builds == ms.BUILDS
    # one build a probe shape, at the shape's cluster size
    assert sorted(builds) == sorted(ms.plan(k, m, ms.CLUSTER[name])
                                    for name, (k, m) in ms.SHAPES.items())
    assert KC["COLS"] == ms.COLS_PER_CLUSTER and KC["MAX_CL"] == 2
    assert KC["NTILE"] == 16 and (KC["B_LBO"], KC["B_SBO"]) == (128, 256)
    assert "A_KSTEP = COLS * 16 * 2" in SRC
    assert "float2 slot[2][MAX_CL][THREADS / 4]" in SRC
    assert "uint64_t bar[2]" in SRC
    assert ms.STATIC_BYTES == (2 * KC["MAX_CL"] * (KC["THREADS"] // 4) * 8
                               + 2 * 8)
    assert "cl != 1 && cl != 2)" in SRC
    # the wgmma widths are the builds' own, none more
    widths = {int(c) for c in re.findall(r"^WG_WIDTH\((\d+),", SRC, re.M)}
    used = set()
    for kt, nt in ms.BUILDS:
        ni = 2 if nt > 16 else 1
        assert nt % ni == 0
        used.add(nt // ni)
    assert widths == used
    assert ("(k & 7) + 8 * (r & 7) + 64 * ((k >> 3) & 1) + 128 * (r >> 3) +"
            "\n         16 * rows * (k >> 4)") in SRC
    # k-step 0 from the fragment, the others from the tile
    assert "packed(16 * warp + g + 8 * (j & 1), 2 * q + 8 * (j >> 1), COLS)" \
        in SRC
    assert "Wg<C>::template mma_rs<0, 0>(acc[0], a0f, bdesc);" in SRC
    assert "A_KSTEP / 16 * (KS + 1), 32 * C * NI * (KS + 1), 1>" in SRC
    assert "std::make_integer_sequence<int, KT - 1>{}" in SRC
    assert "a0f[0] = (a0f[0] & 0xFFFF0000u) | __bfloat16_as_ushort(r0);" in SRC


def packed(r, k, rows):
    """The source's ``packed``: element of (row r, k) in an operand of
    ``rows`` rows a k-step."""
    return ((k & 7) + 8 * (r & 7) + 64 * ((k >> 3) & 1) + 128 * (r >> 3)
            + 16 * rows * (k >> 4))


def read(tile, byte0, rows):
    """The 16 k x ``rows`` operand a no-swizzle K-major descriptor at byte
    ``byte0`` reads: k half LBO apart, 8-row blocks SBO apart, 16 bytes a
    row; [k, row]."""
    out = np.zeros((16, rows))
    for kk in range(16):
        for r in range(rows):
            byte = (byte0 + (kk // 8) * KC["B_LBO"] + (r // 8) * KC["B_SBO"]
                    + (r % 8) * 16 + (kk % 8) * 2)
            out[kk, r] = tile[byte // 2]
    return out


def a0_fragment(at):
    """k-step 0's register-A fragments as the kernel loads them from the
    tile: lane (w, g, q)'s register j holds row 16 w + g + 8 (j & 1), k
    2 q + 8 (j >> 1) and the next k, [w, lane, j, half]."""
    frag = np.zeros((4, 32, 4, 2))
    for wp in range(4):
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            for j in range(4):
                at_j = packed(16 * wp + g + 8 * (j & 1), 2 * q + 8 * (j >> 1),
                              KC["COLS"])
                assert at_j % 2 == 0            # a 32-bit load
                frag[wp, lane, j] = at[at_j:at_j + 2]
    return frag


def a_of_fragment(frag):
    """The 64 x 16 A the fragments give ``wgmma``: each element once."""
    a = np.full((KC["COLS"], 16), np.nan)
    for wp in range(4):
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            for j in range(4):
                row, k = 16 * wp + g + 8 * (j & 1), 2 * q + 8 * (j >> 1)
                for h in range(2):
                    assert np.isnan(a[row, k + h])
                    a[row, k + h] = frag[wp, lane, j, h]
    assert not np.isnan(a).any()
    return a


def model_chain(w, a, n, eps, cl):
    """The kernel's n dots on one cluster (64 columns of a), as its maps
    state them, in numpy; returns a (K, 64) after the dots, bf16 values."""
    k, m = w.shape
    kt, nt = ms.plan(k, m, cl)
    ni = 2 if nt > 16 else 1
    c = nt // ni
    nw, kp, cols = 16 * nt, 16 * kt, KC["COLS"]
    wf, af = w.float().numpy(), a.float().numpy()
    # each rank's packed slice of w, and the A tile (the same in each rank)
    ws = []
    for rank in range(cl):
        t = np.zeros(kp * nw)
        for kk in range(kp):
            for mm in range(nw):
                if kk < k and rank * nw + mm < m:
                    t[packed(mm, kk, nw)] = wf[kk, rank * nw + mm]
        ws.append(t)
    at = np.zeros(kp * cols)
    for kk in range(k):
        for j in range(cols):
            at[packed(j, kk, cols)] = af[kk, j]
    frag = a0_fragment(at)
    np.testing.assert_array_equal(a_of_fragment(frag), read(at, 0, cols).T)
    row0 = torch.from_numpy(af[0].copy()).bfloat16()
    for _ in range(n):
        parts = np.zeros((cl, cols))
        for rank in range(cl):
            d = np.zeros((ni, cols, 16 * c))
            for ks in range(kt):
                # k-step 0 from the registers, the others from the tile
                a_ks = (a_of_fragment(frag) if ks == 0
                        else read(at, 2048 * ks, cols).T)
                for i in range(ni):
                    b = read(ws[rank], 512 * c * (ni * ks + i), 16 * c)
                    d[i] += a_ks @ b
            # the accumulator layout: lane (w, g, q), register e of
            # instruction i holds row 16 w + g + 8 ((e >> 1) & 1), column
            # 8 (e >> 2) + 2 q + (e & 1); a quad's lanes sum their rows
            seen = np.zeros((ni, cols, 16 * c), np.int32)
            for wp in range(4):
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    for i in range(ni):
                        for e in range(8 * c):
                            row = 16 * wp + g + 8 * ((e >> 1) & 1)
                            col = 8 * (e >> 2) + 2 * q + (e & 1)
                            seen[i, row, col] += 1
                            parts[rank, row] += d[i, row, col] ** 2
            assert (seen == 1).all()
        s = torch.from_numpy(parts.sum(0).astype(np.float32))
        row0 = (row0.float() + (s * eps).bfloat16().float()).bfloat16()
        # lanes with q == 0: the low halves of registers 0 and 1
        for wp in range(4):
            for g in range(8):
                for j in range(2):
                    frag[wp, 4 * g, j, 0] = row0[16 * wp + g + 8 * j].float()
    # row 0 back into the tile, the output read from it
    at[[packed(j, 0, cols) for j in range(cols)]] = row0.float().numpy()
    out = a.clone()
    out[:, :cols] = torch.from_numpy(np.array(
        [[at[packed(j, kk, cols)] for j in range(cols)]
         for kk in range(k)], np.float32)).bfloat16()
    return out


@pytest.mark.parametrize("k,m,cl", [(20, 70, 2), (12, 192, 1),
                                    (40, 630, 2)],
                         ids=["two ranks", "one CTA", "two wgmmas a k-step"])
def test_model_of_the_kernel_matches_the_plain_version(k, m, cl):
    """The packed operands read back through their descriptors (k-step 0
    through the register fragments), the accumulator layout (each product
    held once), the quad and cluster sums and the row-0 update in the
    fragments, run for three dots on 64 columns at a visible eps, meet the
    plain version under the card's gates."""
    w, a, _, _ = _inputs(10, k, m, 64)
    eps, n = _common.mma_eps(k, m), 3
    got = model_chain(w, a, n, eps, cl)
    plain = ms.mma_chain_reference(w, a, n, eps)
    text, fails = _common.mma_readings(f"k{k}_m{m}", got, plain, a)
    assert not fails, text
