"""aasist_tpu_torch: the PyTorch / CUDA port of ``aasist_tpu``.

A second package beside the JAX one, which stays the reference it is held
against.  The port mirrors the JAX layout module for module (``nn``,
``models/layers``, ``models/aasist``, ``ops/fused_frontend``, ``serving``,
``registry``, ``config``) but imports neither JAX nor anything of
``aasist_tpu``: the few JAX-free helpers it needs are its own copies.

This slice covers pretrained AASIST eval scoring on an NVIDIA H100.  The
sinc frontend runs through a hand-written CUDA kernel
(``csrc/fused_frontend.cu``), built with ``nvcc`` at first use.  Nothing
heavy is imported here; the kernel library is built and loaded only when a
CUDA tensor first reaches it.
"""

__version__ = "0.1.0"
