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
bf16.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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
        tc.selu_to_nchw(_FakeCuda(x, ptr=4))
    with pytest.raises(ValueError, match="not one of"):
        tc.pool3_time(x, "reshape")
    with pytest.raises(ValueError, match="not one of"):
        tc.pool3_time_reference(x, "reshape")


@pytest.mark.parametrize("how", [None, *tc.SELU_HOW])
def test_selu_to_nchw_formulations_are_one_function(how):
    """On the CPU every ``how`` is the plain version."""
    z, _ = _pair(6, (3, 4, 2, 30), "bfloat16")
    before = tc.selu_to_nchw.launches
    torch.testing.assert_close(tc.selu_to_nchw(z, how),
                               tc.selu_to_nchw_reference(z), rtol=0, atol=0)
    assert tc.selu_to_nchw.launches == before


@pytest.mark.parametrize("dtype,t", [(torch.float32, 30),
                                     (torch.bfloat16, 36)],
                         ids=["float32", "bfloat16"])
def test_selu_to_nchw_vector_needs_whole_vectors(dtype, t):
    """"vector" moves 16 bytes a thread: 4 float32 or 8 bfloat16 values."""
    x = _FakeCuda(torch.zeros((3, 4, 2, t), dtype=dtype))
    with pytest.raises(ValueError, match="no multiple of a 16-byte vector"):
        tc.selu_to_nchw(x, "vector")
    with pytest.raises(ValueError, match="not one of"):
        tc.selu_to_nchw(x, "direct")
