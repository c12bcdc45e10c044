"""The matrix-unit shape probe's kernels: n chained dots on resident
operands, on ``wgmma`` (``csrc/mma_chain_wg.cu``, ``mma_chain``) and on the
older ``mma.sync`` kernel (``csrc/mma_shapes.cu``, ``mma_chain_older``).

Counterpart of ``tools/probe_mxu_shapes.py:_kernel``.  With w (K, M) and a
(K, N), both bf16, each of n iterations computes

    y = w^T a                       (M, N), f32 sums
    s = eps * sum_m y^2             (N,), f32
    a[0] = bf16(a[0] + bf16(s))

so each dot reads what the last one wrote.  Both wrappers return the final
a; the TPU kernel's (8, 128) f32 output is its ``[0:8, 0:128]``.  The TPU
kernel fixes eps at 1e-30, where the bf16 add changes nothing and its output
is a unchanged: the port takes ``eps`` as a keyword with that default, so
that a check can run it where the update shows.

``SHAPES`` are the probe's (K, M) pairs and ``N_COLS`` its N.  The ``wgmma``
kernel chains 64 columns of a a cluster of 1 or 2 CTAs, each holding
ceil(M / cluster) columns of w rounded up to 16 and the 64 columns of a,
both in shared memory; ``CLUSTER`` is the size each probe shape runs at
(the fastest of 1, 2 and 4 in a reading of the three in turns: 2 for the
four largest dots, 1 for the rest; any other shape runs at 1), and
``BUILDS`` the (k-steps, n16 tiles) pairs the source is built for, one a
probe shape.  The older kernel pads K and M to multiples of 16 and takes K up to
384.  Each wrapper raises on a shape it was not built for; CPU tensors take
the plain version, ``mma_chain_reference``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

N_COLS = 2048
EPS = 1e-30
SHAPES = {
    "k132_m210": (132, 210),
    "k144_m630": (144, 630),
    "k192_m32": (192, 32),
    "k384_m96": (384, 96),
    "k384_m64": (384, 64),
    "k128_m128": (128, 128),
    "k256_m256": (256, 256),
    "k12_m192": (12, 192),
    "k96_m96": (96, 96),
    "k96_m192": (96, 192),
    "k192_m96": (192, 96),
    "k192_m64": (192, 64),
}
SMEM_PER_BLOCK = 232448                 # the H100's opt-in shared memory

# csrc/mma_chain_wg.cu
COLS_PER_CLUSTER = 64                   # COLS: wgmma's M
BUILDS = ((9, 7), (9, 20), (12, 2), (24, 3), (24, 4), (8, 8),
          (16, 8), (1, 12), (6, 6), (6, 12), (12, 6), (12, 4))
STATIC_BYTES = 2 * 2 * 32 * 8 + 2 * 8   # the exchange slots and mbarriers
CLUSTER = {name: 1 for name in SHAPES}
CLUSTER.update(k132_m210=2, k144_m630=2, k384_m96=2, k256_m256=2)

# csrc/mma_shapes.cu
K_STEPS = (1, 6, 8, 9, 12, 16, 24)      # K padded to 16 x these: the builds
COLS_PER_CTA = 16                       # NS


def plan(k: int, m: int, cluster: int) -> Tuple[int, int]:
    """(k-steps of 16, n16 tiles of a CTA's slice of w) of the ``wgmma``
    kernel at (K, M) over clusters of ``cluster`` CTAs."""
    cols = -(-m // cluster)
    return -(-k // 16), -(-cols // 16)


def cluster_of(k: int, m: int) -> int:
    """The cluster size ``mma_chain`` runs (K, M) at: ``CLUSTER``'s for a
    probe shape, else 1."""
    return next((CLUSTER[name] for name, shape in SHAPES.items()
                 if shape == (k, m)), 1)


def smem_bytes(k: int, m: int) -> int:
    """Shared memory a CTA of the ``wgmma`` kernel takes at (K, M): its
    slice of w (16 KT rows of 16 NT columns), a's 64 columns, the exchange
    slots and mbarriers."""
    kt, nt = plan(k, m, cluster_of(k, m))
    return 16 * kt * (16 * nt + COLS_PER_CLUSTER) * 2 + STATIC_BYTES


def padded(k: int, m: int):
    """(K, M) padded to the multiples of 16 that the older kernel runs."""
    return -(-k // 16) * 16, -(-m // 16) * 16


def smem_bytes_older(k: int, m: int) -> int:
    """Shared memory a CTA of the older kernel takes: w^T and a 16-column
    slice, rows padded to K + 8, and the warps' column sums."""
    kp, mp = padded(k, m)
    return (mp + COLS_PER_CTA) * (kp + 8) * 2 + 8 * COLS_PER_CTA * 4


def mma_chain_reference(w: torch.Tensor, a: torch.Tensor, n: int,
                        eps: float = EPS) -> torch.Tensor:
    """The plain version: the loop in f32 matmuls, a's row 0 rounded to
    bf16 after the scale and after the add."""
    out = a.clone()
    wt = w.float().t()
    for _ in range(n):
        y = wt @ out.float()
        s = (y * y).sum(0) * eps
        out[0] = (out[0].float() + s.to(out.dtype).float()).to(out.dtype)
    return out


def _check(name: str, w: torch.Tensor, a: torch.Tensor, n: int) -> None:
    for what, t in (("w", w), ("a", a)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device} for "
                             f"{what}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {what} is {t.dtype}; the kernel "
                            "takes bfloat16")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous 2-D "
                             f"tensor, got {tuple(t.shape)}")
    k, m = w.shape
    if a.shape[0] != k or min(k, m, a.shape[1]) < 1 or n < 0:
        raise ValueError(f"{name}: unsupported shapes w {tuple(w.shape)}, "
                         f"a {tuple(a.shape)}, n = {n}")


def _launch(name: str, source: str, entry: str, w: torch.Tensor,
            a: torch.Tensor, n: int, eps: float, *extra) -> torch.Tensor:
    k, m = w.shape
    out = torch.empty(tuple(a.shape), dtype=a.dtype, device=a.device)
    from aasist_tpu_torch.ops import _build
    fn = getattr(_build.load(source).lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * len(extra) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(w.data_ptr(), a.data_ptr(), out.data_ptr(), k, m, a.shape[1],
                 n, eps, *extra,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
    return out


def mma_chain(w: torch.Tensor, a: torch.Tensor, n: int,
              eps: float = EPS) -> torch.Tensor:
    """a (K, N) after ``n`` chained dots with w (K, M) (the module's
    header), bf16, on ``wgmma`` over clusters of ``cluster_of(K, M)`` CTAs.
    Every launch adds one to ``mma_chain.launches``."""
    if w.device.type == "cpu" and a.device.type == "cpu":
        return mma_chain_reference(w, a, n, eps)
    _check("mma_chain", w, a, n)
    k, m = w.shape
    cl = cluster_of(k, m)
    if smem_bytes(k, m) > SMEM_PER_BLOCK:
        raise ValueError(f"mma_chain: a slice of w of ({k}, {m}) and a's "
                         f"columns need {smem_bytes(k, m)} bytes of "
                         "shared memory")
    if plan(k, m, cl) not in BUILDS:
        raise ValueError(f"mma_chain: ({k}, {m}) over clusters of {cl} is "
                         f"(k-steps, n16 tiles) {plan(k, m, cl)}; the kernel "
                         f"is built for {BUILDS}")
    out = _launch("mma_chain", "mma_chain_wg", "aasist_mma_chain_wg", w, a,
                  n, eps, cl)
    mma_chain.launches += 1
    return out


def mma_chain_older(w: torch.Tensor, a: torch.Tensor, n: int,
                    eps: float = EPS) -> torch.Tensor:
    """``mma_chain`` on the older ``mma.sync`` kernel
    (``csrc/mma_shapes.cu``: a CTA of 8 warps on each 16 columns of a, w^T
    in shared memory).  Every launch adds one to
    ``mma_chain_older.launches``."""
    if w.device.type == "cpu" and a.device.type == "cpu":
        return mma_chain_reference(w, a, n, eps)
    _check("mma_chain_older", w, a, n)
    k, m = w.shape
    if -(-k // 16) not in K_STEPS:
        raise ValueError(f"mma_chain_older: K = {k} pads to {-(-k // 16)} "
                         f"k-steps; the kernel is built for {K_STEPS}")
    if smem_bytes_older(k, m) > SMEM_PER_BLOCK:
        raise ValueError(f"mma_chain_older: w^T of ({k}, {m}) and a column "
                         f"slice need {smem_bytes_older(k, m)} bytes of "
                         "shared memory")
    out = _launch("mma_chain_older", "mma_shapes", "aasist_mma_chain", w, a,
                  n, eps)
    mma_chain_older.launches += 1
    return out


mma_chain.launches = 0
mma_chain_older.launches = 0
