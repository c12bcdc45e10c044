"""The plain versions of the block-0 tail kernels
(``aasist_tpu_torch/ops/tail_constructs``) against the functions of
``tools/probe_tail_constructs.py``, on the CPU.

That probe defines its Pallas kernels inside ``main()``, which times them on
the device, so they cannot be imported.  Their bodies are one expression
each, restated here in ``jax.numpy`` on the same numpy inputs: the max over
reshaped time triples (``pool_reshape_kernel``, ``pool_sublane_kernel``), the
max of three stride-3 slices (``pool_strided_kernel``), and
``tools/fused_stack.py:_selu`` in f32 followed by the transpose
(``geg_kernel``).  A max of stored values is exact: the pools are held at 0.
SELU differs by the exponential's last bits: 1e-6 in f32, one bf16 ulp in
bf16.  ``selu_to_nchw`` (``csrc/selu_nchw.cu``) and ``selu_to_nchw_older``
(``csrc/tail_constructs.cu``) take the same plain version on the CPU: the
JAX comparison runs once, and one test asserts that both names dispatch to
it.  A numpy model of ``csrc/selu_nchw.cu``'s index maps (aligned vectors,
the neighbour from the next lane, the realignment, the head and tail
elements) moves rows of every alignment and checks each output element is
written once, with nothing outside the output.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aasist_tpu_torch.ops import _build
from aasist_tpu_torch.ops import tail_constructs as tc

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tools"))
import fused_stack as FS  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(seed, shape, dname):
    """The same values as a torch and a jax array of type ``dname``."""
    tdt, jdt = DTYPES[dname]
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, shape).astype(np.float32)).to(tdt)
    return x, jnp.asarray(x.float().numpy(), jdt)


def _np(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("how", tc.POOL_HOW)
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 32, 23, 3 * 40), (3, 4, 5, 100)],
                         ids=["whole triples", "T % 3 = 1"])
def test_pool3_time_matches_jnp(shape, dname, how):
    y, yj = _pair(1, shape, dname)
    v = shape[-1] // 3
    yj = yj[..., :3 * v]
    reshaped = jnp.max(yj.reshape(*shape[:-1], v, 3), axis=-1)
    strided = jnp.maximum(jnp.maximum(yj[..., 0::3], yj[..., 1::3]),
                          yj[..., 2::3])
    got = tc.pool3_time(y, how)
    assert got.dtype == y.dtype and tuple(got.shape) == (*shape[:-1], v)
    np.testing.assert_array_equal(got.float().numpy(), _np(reshaped))
    np.testing.assert_array_equal(got.float().numpy(), _np(strided))


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 32, 3 * 40, 23), (3, 4, 101, 5)],
                         ids=["whole triples", "T % 3 = 2"])
def test_pool3_time_major_matches_jnp(shape, dname):
    y, yj = _pair(2, shape, dname)
    b, c, t, f = shape
    ref = jnp.max(yj[:, :, :3 * (t // 3)].reshape(b, c, t // 3, 3, f), axis=3)
    got = tc.pool3_time_major(y)
    assert got.dtype == y.dtype and tuple(got.shape) == (b, c, t // 3, f)
    np.testing.assert_array_equal(got.float().numpy(), _np(ref))
    # the same function as the pool over the last axis of the transpose
    np.testing.assert_array_equal(
        got.float().numpy(),
        tc.pool3_time(y.transpose(2, 3).contiguous()).transpose(2, 3)
        .float().numpy())


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("shape", [(32, 24, 2, 64), (3, 5, 4, 37)],
                         ids=["block 0", "odd sizes"])
def test_selu_to_nchw_matches_jnp(shape, dname):
    z, zj = _pair(3, shape, dname)
    ref = jnp.transpose(FS._selu(zj.astype(jnp.float32)).astype(zj.dtype),
                        (2, 0, 1, 3))
    got = tc.selu_to_nchw(z)
    c, f1, b, t = shape
    assert got.dtype == z.dtype and tuple(got.shape) == (b, c, f1, t)
    assert got.is_contiguous()
    tol = (dict(atol=1e-6, rtol=1e-6) if dname == "float32"
           else dict(atol=1e-6, rtol=2.0 ** -7))
    np.testing.assert_allclose(got.float().numpy(), _np(ref), **tol)


CALLS = {"pool3_time": ((2, 3, 4, 30), ("staged",)),
         "pool3_time_major": ((2, 3, 30, 4), ()),
         "selu_to_nchw": ((3, 4, 2, 30), ())}


@pytest.mark.parametrize("name", list(CALLS))
def test_cpu_tensors_take_the_plain_versions(name):
    """A CPU tensor is no kernel launch and equals the plain version; a
    device that is neither CPU nor CUDA raises."""
    shape, extra = CALLS[name]
    x, _ = _pair(4, shape, "float32")
    fn, ref_fn = getattr(tc, name), getattr(tc, name + "_reference")
    before = fn.launches
    torch.testing.assert_close(fn(x, *extra), ref_fn(x, *extra), rtol=0,
                               atol=0)
    assert fn.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fn(x.to("meta"), *extra)


class _FakeCuda:
    """Stands in for a CUDA tensor in the guards, which read ``device``,
    ``dtype``, ``dim``, ``shape``, ``is_contiguous`` and ``data_ptr`` before
    any launch."""

    def __init__(self, t, contiguous=True, ptr=None):
        self._t, self._c, self._ptr = t, contiguous, ptr
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._c

    def data_ptr(self):
        return self._t.data_ptr() if self._ptr is None else self._ptr


@pytest.mark.parametrize("name", list(CALLS))
def test_cuda_call_without_a_card_raises(name):
    """With no card a tensor cannot be moved to ``cuda``, and a call whose
    tensor claims to be there and passes every guard raises before any
    result comes back, with no launch counted."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    shape, extra = CALLS[name]
    x, _ = _pair(5, shape, "bfloat16")
    fn = getattr(tc, name)
    with pytest.raises((RuntimeError, AssertionError)):
        fn(x.to("cuda"), *extra)
    before = fn.launches
    with pytest.raises((RuntimeError, AssertionError)):
        fn(_FakeCuda(x), *extra)         # allocating the output raises
    assert fn.launches == before


GUARDS = [
    ("float16", torch.float16, None, True, TypeError, "not supported"),
    ("a 3-D tensor", torch.float32, (2, 3, 30), True, ValueError,
     "contiguous"),
    ("a strided tensor", torch.float32, None, False, ValueError,
     "contiguous"),
    ("an empty axis", torch.float32, (2, 0, 30, 30), True, ValueError,
     "unsupported shape"),
]


@pytest.mark.parametrize("what,dtype,shape,contig,exc,match", GUARDS,
                         ids=[g[0] for g in GUARDS])
@pytest.mark.parametrize("name", list(CALLS))
def test_guards_raise(name, what, dtype, shape, contig, exc, match):
    ok_shape, extra = CALLS[name]
    x = _FakeCuda(torch.zeros(shape or ok_shape, dtype=dtype), contig)
    with pytest.raises(exc, match=match):
        getattr(tc, name)(x, *extra)


@pytest.mark.parametrize("name,shape", [("pool3_time", (2, 3, 4, 2)),
                                        ("pool3_time_major", (2, 3, 2, 4))])
def test_fewer_than_three_times_raises(name, shape):
    with pytest.raises(ValueError, match="unsupported shape"):
        getattr(tc, name)(_FakeCuda(torch.zeros(shape)))


def test_staged_pool_needs_alignment_and_a_known_formulation():
    x = torch.zeros((2, 3, 4, 30))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tc.pool3_time(_FakeCuda(x, ptr=4), "staged")
    with pytest.raises(ValueError, match="16-byte aligned"):
        tc.selu_to_nchw_older(_FakeCuda(x, ptr=4))
    with pytest.raises(ValueError, match="not one of"):
        tc.pool3_time(x, "reshape")
    with pytest.raises(ValueError, match="not one of"):
        tc.pool3_time_reference(x, "reshape")


@pytest.mark.parametrize("how", [None, *tc.SELU_HOW])
def test_selu_to_nchw_formulations_are_one_function(how):
    """On the CPU every ``how`` of the older kernels is the plain
    version."""
    z, _ = _pair(6, (3, 4, 2, 30), "bfloat16")
    before = tc.selu_to_nchw_older.launches
    torch.testing.assert_close(tc.selu_to_nchw_older(z, how),
                               tc.selu_to_nchw_reference(z), rtol=0, atol=0)
    assert tc.selu_to_nchw_older.launches == before


@pytest.mark.parametrize("dtype,t", [(torch.float32, 30),
                                     (torch.bfloat16, 36)],
                         ids=["float32", "bfloat16"])
def test_selu_to_nchw_vector_needs_whole_vectors(dtype, t):
    """The older "vector" moves 16 bytes a thread: 4 float32 or 8 bfloat16
    values."""
    x = _FakeCuda(torch.zeros((3, 4, 2, t), dtype=dtype))
    with pytest.raises(ValueError, match="no multiple of a 16-byte vector"):
        tc.selu_to_nchw_older(x, "vector")
    with pytest.raises(ValueError, match="not one of"):
        tc.selu_to_nchw_older(x, "direct")


# ------------------------------- selu_to_nchw, its cut and older builds
def test_both_selu_wrappers_dispatch_to_the_plain_version(monkeypatch):
    """On CPU tensors ``selu_to_nchw`` and ``selu_to_nchw_older`` both
    return ``selu_to_nchw_reference``'s result and count no launch: the JAX
    comparison above holds for both."""
    calls = []

    def plain(z):
        calls.append(tuple(z.shape))
        return z
    monkeypatch.setattr(tc, "selu_to_nchw_reference", plain)
    z, _ = _pair(7, (3, 4, 2, 30), "bfloat16")
    for fn in (tc.selu_to_nchw, tc.selu_to_nchw_older):
        before = fn.launches
        assert fn(z) is z and fn.launches == before
    assert calls == [(3, 4, 2, 30)] * 2


def test_selu_to_nchw_out_and_cut_on_the_cpu():
    """``out`` is written in place with the plain version; the cut is the
    permuted copy; neither counts a launch."""
    z, _ = _pair(8, (3, 4, 2, 37), "float32")
    out = torch.full((2, 3, 4, 37), float("nan"))
    before = (tc.selu_to_nchw.launches, tc.selu_to_nchw_cut.launches)
    assert tc.selu_to_nchw(z, out=out) is out
    torch.testing.assert_close(out, tc.selu_to_nchw_reference(z), rtol=0,
                               atol=0)
    torch.testing.assert_close(tc.selu_to_nchw_cut(z),
                               z.permute(2, 0, 1, 3), rtol=0, atol=0)
    assert (tc.selu_to_nchw.launches, tc.selu_to_nchw_cut.launches) == before


@pytest.mark.parametrize("shape,dtype", [((2, 3, 4, 30), torch.float32),
                                         ((2, 3, 4, 37), torch.bfloat16)],
                         ids=["shape", "dtype"])
def test_selu_to_nchw_out_guard(shape, dtype):
    z = _FakeCuda(torch.zeros((3, 4, 2, 37)))
    out = _FakeCuda(torch.zeros(shape, dtype=dtype))
    with pytest.raises(ValueError, match="out must be"):
        tc.selu_to_nchw(z, out=out)


class _Built(Exception):
    pass


@pytest.mark.parametrize("name,build", [
    ("selu_to_nchw", ("selu_nchw", None)),
    ("selu_to_nchw_cut", ("selu_nchw", {"SNC_CUT": 1})),
    ("selu_to_nchw_older", ("tail_constructs", None))])
def test_selu_wrappers_launch_their_builds(monkeypatch, name, build):
    """``selu_to_nchw`` asks for ``csrc/selu_nchw.cu``, its cut for the
    ``SNC_CUT`` build, ``selu_to_nchw_older`` for
    ``csrc/tail_constructs.cu``; none counts a launch when the build stops
    it.  The new kernel takes bases at any 2-byte alignment."""
    seen = []

    def load(src, defines=None):
        seen.append((src, defines))
        raise _Built
    empty = torch.empty
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch, "empty", lambda shape, dtype, device:
                        empty(shape, dtype=dtype))
    x = torch.zeros((3, 4, 2, 30), dtype=torch.bfloat16)
    fn = getattr(tc, name)
    before = fn.launches
    with pytest.raises(_Built):
        fn(_FakeCuda(x, ptr=2 if name != "selu_to_nchw_older" else None))
    assert seen == [build] and fn.launches == before
    assert tc.CUT_DEFINES == {"SNC_CUT": 1}


def test_probe_builds_are_the_wrappers():
    """The tail probe builds what the wrappers launch, the cut included."""
    from aasist_tpu_torch.tools import probe_tail_constructs as ptc

    assert ptc.BUILDS == [("tail_constructs", None), ("selu_nchw", None),
                          ("selu_nchw", tc.CUT_DEFINES)]
    assert sorted({t % 8 for t in ptc.EDGE_T}) == list(range(8))
    assert ptc.SELU_TOL["float32"] == dict(atol=1e-6, rtol=1e-6)
    assert ptc.SELU_TOL["bfloat16"] == dict(atol=1e-6, rtol=2.0 ** -7)


@pytest.mark.parametrize("what,dtype,shape,contig,exc,match", GUARDS,
                         ids=[g[0] for g in GUARDS])
def test_older_selu_guards_raise(what, dtype, shape, contig, exc, match):
    x = _FakeCuda(torch.zeros(shape or (3, 4, 2, 30), dtype=dtype), contig)
    with pytest.raises(exc, match=match):
        tc.selu_to_nchw_older(x)


# ------------------------------------- a numpy model of selu_nchw.cu
SNC = (_build.CSRC / "selu_nchw.cu").read_text()
SK = {m[1]: int(m[2]) for m in re.finditer(r"constexpr int (\w+) = (\d+);",
                                           SNC)}


def test_selu_source_constants():
    assert SK["U"] == 4 and SK["THREADS"] == 256
    assert "constexpr int PASS = 32 * U;" in SNC
    assert "const I dp = in0 - so + VEC;" in SNC
    assert "const I nvo = (so + t + VEC - 1) / VEC;" in SNC


def model_rows(z, esize, z_off, o_off):
    """``selu_nchw_kernel``'s index maps on flat buffers whose bases lie
    z_off and o_off elements past a 16-byte boundary (the kernel's layout
    change without SELU): every row's passes of 32 U output vectors, lane
    L's aligned input vectors and its neighbour's (lane 0's next one for
    lane 31), the realignment by (input - output offset) mod 16 bytes, and
    head and tail elements stored one by one.  Returns the output and
    every element's store count."""
    vec, u_, pas = 16 // esize, SK["U"], 32 * SK["U"]
    c, f1, b, t = z.shape
    cf, n = c * f1, z.size
    zb = np.full(z_off + n + 2 * vec, np.nan)
    zb[z_off:z_off + n] = z.ravel()
    ob = np.full(o_off + n + 2 * vec, np.nan)
    count = np.zeros_like(ob, np.int64)
    lo, hi = z_off, z_off + n
    vlo, vhi = (z_off + vec - 1) // vec, hi // vec

    def load(iv):
        if vlo <= iv < vhi:
            return zb[iv * vec:iv * vec + vec].copy()
        e = np.zeros(vec)
        for k in range(vec):
            if lo <= iv * vec + k < hi:
                e[k] = zb[iv * vec + k]
        return e
    for r in range(cf * b):
        bb, q = r // cf, r % cf
        in0, out0 = z_off + (q * b + bb) * t, o_off + r * t
        so = out0 % vec
        dp = in0 - so + vec
        qd, sb = dp // vec - 1, (dp % vec) * esize
        ao, nvo = (out0 - so) // vec, (so + t + vec - 1) // vec
        for base in range(0, nvo, pas):
            cur = [[load(qd + base + 32 * u + lane)
                    if base + 32 * u + lane <= nvo else np.zeros(vec)
                    for lane in range(32)] for u in range(u_)]
            extra = (load(qd + base + pas) if base + pas <= nvo
                     else np.zeros(vec))
            for u in range(u_):
                for lane in range(32):
                    src = (lane + 1) & 31
                    nxt = ((cur[u + 1][0] if u + 1 < u_ else extra)
                           if src == 0 else cur[u][src])
                    v = base + 32 * u + lane
                    if v >= nvo:
                        continue
                    o = np.concatenate([cur[u][lane], nxt])[
                        sb // esize:sb // esize + vec]
                    e0 = (ao + v) * vec
                    for k in range(vec):
                        if out0 <= e0 + k < out0 + t:
                            ob[e0 + k] = o[k]
                            count[e0 + k] += 1
    return ob, count


@pytest.mark.parametrize("esize", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("t", [1, 7, 9, 200, 203, 300],
                         ids=lambda t: f"T={t}")
def test_model_of_the_kernel_moves_every_row(esize, t):
    """At every T mod 8 and bases off a 16-byte boundary, each output
    element is stored once, with its input's value, and nothing around the
    output is touched."""
    vec = 16 // esize
    z = np.random.default_rng(t).normal(size=(2, 3, 2, t))
    for z_off, o_off in [(0, 0), (1, 0), (0, vec - 1), (vec - 1, 1)]:
        ob, count = model_rows(z, esize, z_off, o_off)
        n = z.size
        assert (count[o_off:o_off + n] == 1).all()
        assert count[:o_off].sum() == 0 and count[o_off + n:].sum() == 0
        np.testing.assert_array_equal(
            ob[o_off:o_off + n].reshape(2, 2, 3, t), z.transpose(2, 0, 1, 3))
