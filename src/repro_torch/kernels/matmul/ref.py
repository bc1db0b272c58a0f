"""Plain torch version of the tiled matmul kernel K3.

Port of ``repro/kernels/matmul/ref.py`` (``jnp.dot`` with an f32
accumulator, cast to x's dtype).  It is what ``csrc/matmul.cu`` is held
against on the card and what ``matmul.py`` runs for tensors on the CPU.

It sums over k in one fixed order, k = 0 .. K-1, one f32 product and one
f32 sum per step, so every output element is computed the same way whatever
M, N or the row offset: a product of 2 rows of x equals those rows of the
full product, bit for bit, which the TDA's exactness checks rely on.  A
plain ``x.float() @ y.float()`` is not so on the CPU: MKL's sgemm gives 2-row
slices that differ from the full product at (500, 500, 500) with 8 threads
and at (1000, 1000, 1000) with one, though not at the smaller shapes the
reference's tests use.
"""

from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in x's dtype, accumulated in f32 in k
    order."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    xf, yf = x.float(), y.float()
    acc = torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(x.shape[1]):
        acc += xf[:, k, None] * yf[k]
    return acc.to(x.dtype)
