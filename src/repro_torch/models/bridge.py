"""Params bridge: the reference's params, handed over as numpy arrays, as
the port's params.

The JAX package's params pytree is nested dicts (and, for prefix layers,
lists) of arrays; the port lays its params out identically, so the bridge
maps leaves one to one and the two packages compute the same function.  The
caller converts the JAX leaves with ``np.asarray`` (this package never
imports JAX); bfloat16 leaves arrive as numpy's ``bfloat16`` extension
dtype and are reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(arr, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """One numpy leaf as a tensor on ``device``, cast to ``dtype`` if given."""
    arr = np.array(arr)    # a writable copy: arrays from JAX are read-only
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device)
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def params_from_numpy(tree: Any, device, dtype: torch.dtype | None = None) -> Any:
    """Map a nested dict/list of numpy arrays to the same structure of
    tensors on ``device`` (floating leaves cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    return tensor_from_numpy(tree, device, dtype)
