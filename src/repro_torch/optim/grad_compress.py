"""int8 error-feedback gradient compression for the DP all-reduce.

Port of ``repro/optim/grad_compress.py``: each gradient is quantized to int8
with a per-tensor absmax scale before the (simulated) collective, and the
quantization residual is kept locally and added back next time (error
feedback).  Compression is simulated faithfully (quantize -> dequantize);
on a real fleet the int8 payload is what crosses the wire.
"""

from __future__ import annotations

import torch

from ..tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["compress", "decompress", "ef_compress_tree", "init_residuals",
           "compressed_bytes"]


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization.  Returns (q, scale)."""
    gf = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads, residuals):
    """Error-feedback compression over a pytree.

    Returns (dequantized grads to feed the all-reduce/optimizer,
             new residuals = (g + r) - dequant(q))."""

    def one(g, r):
        corrected = g.to(torch.float32) + r
        q, s = compress(corrected)
        deq = decompress(q, s)
        return deq, corrected - deq

    flat_g, treedef = tree_flatten(grads)
    flat_r = tree_flatten(residuals)[0]
    outs = [one(g, r) for g, r in zip(flat_g, flat_r, strict=True)]
    deq = tree_unflatten(treedef, [o[0] for o in outs])
    res = tree_unflatten(treedef, [o[1] for o in outs])
    return deq, res


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_bytes(params) -> int:
    """Bytes crossing the wire per step with int8 + f32 scale per tensor."""
    leaves = tree_flatten(params)[0]
    return sum(leaf.numel() for leaf in leaves) + 4 * len(leaves)
