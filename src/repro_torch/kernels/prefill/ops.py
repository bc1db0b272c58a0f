"""Public prefill op: GQA head handling + block dispatch + cache emission.

Port of ``repro/kernels/prefill/ops.py``.  Callers (the bucketed
``DecodeEngine.prefill`` fast path) pad the prompt to a length bucket
*before* projection, so Sq here is always the bucket size.  The Pallas
wrapper fits its blocks to S (tuned or default, halved until they divide
S); the CUDA kernel has one compiled 64 x 64 tile and masks the ragged edge
instead, so every bucket, a clamped one (``length_bucket(40, 48) == 48``)
included, runs the same launch and no block sizes are passed.
"""

from __future__ import annotations

import torch

from .prefill import prefill_flash as _prefill_call
from .ref import prefill_ref as _prefill_ref

#: Prompt-length bucket ladder: prompts are right-padded to the next power of
#: two in [MIN_BUCKET, max_seq]; one prefill shape per rung.
MIN_BUCKET = 16


def length_bucket(n: int, max_seq: int) -> int:
    """Next-power-of-two bucket for a prompt of length ``n``, clamped to
    [MIN_BUCKET, max_seq]."""
    if n > max_seq:
        raise ValueError(f"prompt length {n} exceeds max_seq {max_seq}")
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, max_seq)


def prefill_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    *,
    cache_dtype: torch.dtype | None = None,
    use_pallas: bool | None = None,
):
    """Fused causal prefill attention.  Returns
    ``(out (B,S,Hq,D), k_cache (B,S,Hkv,D), v_cache (B,S,Hkv,D))`` with the
    cache tensors in ``cache_dtype`` (default: input dtype).

    ``use_pallas`` keeps the reference's name for the kernel route: None
    means the kernel for tensors on CUDA; True routes through
    ``prefill_flash`` (which takes its plain version on the CPU); False is
    the plain version on any device."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hkv | Hq, got {hkv}, {hq}")
    if use_pallas is None:
        use_pallas = q.device.type == "cuda"
    rep = hq // hkv
    qf = q.transpose(1, 2).reshape(b * hq, s, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, s, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, s, d).contiguous()
    run = _prefill_call if use_pallas else _prefill_ref
    out, kc, vc = run(qf, kf, vf, cache_dtype=cache_dtype, group=rep)
    return (
        out.reshape(b, hq, s, d).transpose(1, 2),
        kc.reshape(b, hkv, s, d).transpose(1, 2),
        vc.reshape(b, hkv, s, d).transpose(1, 2),
    )
