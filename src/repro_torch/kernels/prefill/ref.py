"""Plain torch versions of the fused prefill op (attention + cache cast).

Port of ``repro/kernels/prefill/ref.py`` (and of the flash-attention oracle
it calls).  These are what the CUDA kernels in ``csrc/prefill.cu`` are held
against on the card, and what ``prefill.py`` runs for tensors on the CPU.
"""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """(BH, Sq, D) x (BH, Skv, D) -> (BH, Sq, D), softmax in f32."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def cache_cast_ref(k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype):
    """The plain version of the cache-cast kernel: ``.to(dtype)``."""
    return k.to(dtype), v.to(dtype)


def prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                cache_dtype: torch.dtype | None = None, group: int = 1):
    """(B*Hq, S, D) x (B*Hkv, S, D) -> (out, k_cache, v_cache).

    Causal attention in f32 (full logits) plus the cache-dtype K/V copies —
    the reference for ``prefill_flash``."""
    if group > 1:
        kr = torch.repeat_interleave(k, group, dim=0)
        vr = torch.repeat_interleave(v, group, dim=0)
    else:
        kr, vr = k, v
    out = attention_ref(q, kr, vr, causal=True)
    kc, vc = cache_cast_ref(k, v, cache_dtype or k.dtype)
    return out, kc, vc
