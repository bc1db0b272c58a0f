"""Public flash-attention op: GQA head layout + dispatch.

Port of ``repro/kernels/flash_attention/ops.py``.  The Pallas wrapper picks
its blocks (tuned or 512/512) and halves them until they divide Sq and Skv;
the CUDA kernels have one compiled tile and mask the ragged edges instead,
so no block sizes are taken.  The op is differentiable on both routes: on
CUDA through the kernels' own backward, on the CPU by autograd through the
plain version.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention as _flash_call
from .ref import flash_attention_ref as _flash_ref


def mha(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    *,
    causal: bool = True,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Multi-head attention with GQA (Hkv divides Hq).  Returns (B, Sq, Hq, D).

    ``use_pallas`` keeps the reference's name for the kernel route: None
    means the kernel for tensors on CUDA; True routes through
    ``flash_attention`` (which takes its plain version on the CPU); False is
    the plain version on any device."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA needs Hkv | Hq, got {hkv}, {hq}")
    if use_pallas is None:
        use_pallas = q.device.type == "cuda"
    qf = q.transpose(1, 2).reshape(b * hq, sq, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, skv, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, skv, d).contiguous()
    run = _flash_call if use_pallas else _flash_ref
    out = run(qf, kf, vf, causal=causal, group=hq // hkv)
    return out.reshape(b, hq, sq, d).transpose(1, 2)
