"""repro_torch: the PyTorch/CUDA port of ``repro``, module for module.

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch on an NVIDIA GPU, and every Pallas TPU kernel on a
ported path becomes a hand-written CUDA kernel (``kernels/*/csrc``).  It
imports neither JAX nor anything of ``repro``: the JAX-free control plane
(``core``, ``obs``, ``coord``, ``cluster``, ``serve``) is kept as its own
copy.

Entry points (``Model``, ``DecodeEngine``, ``Cluster``) run on ``cuda``
unless the caller passes ``device="cpu"`` (see ``device.py``).
"""

__version__ = "0.1.0"
