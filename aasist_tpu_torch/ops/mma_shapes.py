"""The matrix-unit shape probe's kernel (``csrc/mma_shapes.cu``): n chained
dots on resident operands.

Counterpart of ``tools/probe_mxu_shapes.py:_kernel``.  With w (K, M) and a
(K, N), both bf16, each of n iterations computes

    y = w^T a                       (M, N), f32 sums
    s = eps * sum_m y^2             (N,), f32
    a[0] = bf16(a[0] + bf16(s))

so each dot reads what the last one wrote.  ``mma_chain`` returns the final
a; the TPU kernel's (8, 128) f32 output is its ``[0:8, 0:128]``.  The TPU
kernel fixes eps at 1e-30, where the bf16 add changes nothing and its output
is a unchanged: the port takes ``eps`` as a keyword with that default, so
that a check can run it where the update shows.

``SHAPES`` are the probe's (K, M) pairs and ``N_COLS`` its N.  The kernel
pads K and M to multiples of 16 and takes K up to 384; the wrapper raises
on a K it was not built for.  CPU tensors take the plain version,
``mma_chain_reference``.
"""

from __future__ import annotations

import ctypes

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
K_STEPS = (1, 6, 8, 9, 12, 16, 24)      # K padded to 16 x these: the builds
COLS_PER_CTA = 16                       # csrc/mma_shapes.cu:NS
SMEM_PER_BLOCK = 232448                 # the H100's opt-in shared memory


def padded(k: int, m: int):
    """(K, M) padded to the multiples of 16 that ``mma.sync`` runs."""
    return -(-k // 16) * 16, -(-m // 16) * 16


def smem_bytes(k: int, m: int) -> int:
    """Shared memory a CTA of the kernel takes: w^T and a 16-column slice,
    rows padded to K + 8, and the warps' column sums."""
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


def _check(w: torch.Tensor, a: torch.Tensor, n: int) -> None:
    for name, t in (("w", w), ("a", a)):
        if t.device.type != "cuda":
            raise ValueError(f"mma_chain: unsupported device {t.device} for "
                             f"{name}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"mma_chain: {name} is {t.dtype}; the kernel "
                            "takes bfloat16")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"mma_chain: {name} must be a contiguous 2-D "
                             f"tensor, got {tuple(t.shape)}")
    k, m = w.shape
    if a.shape[0] != k or min(k, m, a.shape[1]) < 1 or n < 0:
        raise ValueError(f"mma_chain: unsupported shapes w {tuple(w.shape)}, "
                         f"a {tuple(a.shape)}, n = {n}")
    if -(-k // 16) not in K_STEPS:
        raise ValueError(f"mma_chain: K = {k} pads to {-(-k // 16)} k-steps; "
                         f"the kernel is built for {K_STEPS}")
    if smem_bytes(k, m) > SMEM_PER_BLOCK:
        raise ValueError(f"mma_chain: w^T of ({k}, {m}) and a column slice "
                         f"need {smem_bytes(k, m)} bytes of shared memory")


def mma_chain(w: torch.Tensor, a: torch.Tensor, n: int,
              eps: float = EPS) -> torch.Tensor:
    """a (K, N) after ``n`` chained dots with w (K, M) (the module's
    header), bf16.  Every launch adds one to ``mma_chain.launches``."""
    if w.device.type == "cpu" and a.device.type == "cpu":
        return mma_chain_reference(w, a, n, eps)
    _check(w, a, n)
    k, m = w.shape
    out = torch.empty(tuple(a.shape), dtype=a.dtype, device=a.device)
    from aasist_tpu_torch.ops import _build
    fn = _build.load("mma_shapes").lib.aasist_mma_chain
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(w.data_ptr(), a.data_ptr(), out.data_ptr(), k, m, a.shape[1],
                 n, eps, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mma_chain: CUDA launch failed (cudaError_t "
                           f"{err})")
    mma_chain.launches += 1
    return out


mma_chain.launches = 0
