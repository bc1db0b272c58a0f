"""Plain torch version of flash attention (materializes the full logits).

Port of ``repro/kernels/flash_attention/ref.py``.  It is what the CUDA
kernels in ``csrc/flash_attention.cu`` are held against on the card (the
forward directly, the backward through autograd), and what
``flash_attention.py`` runs for tensors on the CPU.

The scores are formed in K4's arithmetic order: q scaled by 1/sqrt(D) in
f32 first (as the Pallas kernel does too), then one fused multiply-add per
head-dim element in ascending order.  With large logits (the reference's
x30-magnitude case: scores in the thousands) two f32 dot products summed in
different orders differ by about 1e-4 in a score, which moves an output by
as much, past the f32 tolerance; the reference's own kernel test compares
two routes that share XLA's dot.  The softmax, the masking and the
products with V stay plain torch.
"""

from __future__ import annotations

import torch


def scores_ref(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(BH, Sq, D) x (BH, Skv, D) -> (BH, Sq, Skv) f32 scores
    (q / sqrt(D)) . k, summed over d = 0 .. D-1 with one FMA each."""
    d = q.shape[-1]
    qs = q.float() * (1.0 / d ** 0.5)
    kf = k.float()
    s = torch.zeros((q.shape[0], q.shape[1], k.shape[1]), dtype=torch.float32,
                    device=q.device)
    for i in range(d):
        s = torch.addcmul(s, qs[:, :, i, None], kf[:, None, :, i])
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """(BH, Sq, D) x (BH, Skv, D) -> (BH, Sq, D), softmax in f32; the causal
    mask is top-left aligned (query i sees key j iff i >= j)."""
    s = scores_ref(q, k)
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, group: int = 1) -> torch.Tensor:
    """The GQA-native signature of the kernel, (B*Hq, Sq, D) x
    (B*Hkv, Skv, D): K/V rows repeated ``group`` times, then
    ``attention_ref``.  Differentiable by autograd."""
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=0)
        v = torch.repeat_interleave(v, group, dim=0)
    return attention_ref(q, k, v, causal=causal)
