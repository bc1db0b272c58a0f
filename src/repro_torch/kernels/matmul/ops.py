"""Public matmul op: layout + dispatch to kernel K3 or its plain version.

Port of ``repro/kernels/matmul/ops.py``.  The Pallas wrapper pads x and y to
MXU-aligned tiles, picks its blocks by shape bucket (autotune registry or
256/256/512) and slices the result back.  The CUDA kernel picks its tile by
M itself, runs one k-order chain per output element in either, and masks
the ragged edges, so nothing is padded and no block sizes are taken: a
K-reduction order that followed the shape would break the bitwise
row-slice invariance the TDA's 2-row grains rely on.
"""

from __future__ import annotations

import torch

from .matmul import matmul as _matmul_call


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y with an f32 accumulator, in x's dtype: K3 on CUDA tensors, the
    plain version (``ref.matmul_ref``) on CPU tensors."""
    return _matmul_call(x.contiguous(), y.contiguous())
