"""GQA attention: prefill (returns cache) and decode.

Port of ``repro/models/attention.py`` for the dense decoder.  Full (Sq, Skv)
logits are only materialized when ``S <= cfg.attn_chunk``; beyond that the
chunked path (a loop over query chunks with online softmax over key chunks)
keeps the live logits block at ``attn_chunk^2``.  On CUDA the prefill goes
through the hand-written bucketed prefill kernel (``kernels/prefill``).

Decode reads a cache laid out (B, S, Hkv, Dh), as the reference does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.prefill.ops import prefill_attention
from .config import ModelConfig
from .layers import apply_rope, dense_init, dtype_of, rms_norm

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor       # (B, S, Hkv, Dh)
    v: torch.Tensor       # (B, S, Hkv, Dh)


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg.param_dtype)
    hq, hkv, dh = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (cfg.d_model, hq, dh), dt),
        "wk": dense_init(gen, (cfg.d_model, hkv, dh), dt),
        "wv": dense_init(gen, (cfg.d_model, hkv, dh), dt),
        "wo": dense_init(gen, (hq, dh, cfg.d_model), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, dh), dtype=dt, device=dev)
        p["bk"] = torch.zeros((hkv, dh), dtype=dt, device=dev)
        p["bv"] = torch.zeros((hkv, dh), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((dh,), dtype=dt, device=dev)
    return p


def _project_qkv(p: dict, cfg: ModelConfig, xq: torch.Tensor,
                 xkv: torch.Tensor, q_positions, kv_positions):
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, q_positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, kv_positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _sdpa_full(q, k, v, *, causal: bool, kv_mask=None) -> torch.Tensor:
    """Materialized-logits attention, f32 softmax.  q:(B,S,H,D) k/v:(B,T,Hkv,D).

    GQA by *grouped einsum*: Q is reshaped to (B,S,Hkv,G,D), so K/V are
    never repeated."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / dh ** 0.5
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where((qi >= kj)[None, None, None], s, NEG_INF)
    if kv_mask is not None:  # (B, T) valid-key mask
        s = torch.where(kv_mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, sq, hq, dh)


def _sdpa_chunked(q, k, v, *, causal: bool, chunk: int = 1024,
                  chunk_k: int = 0) -> torch.Tensor:
    """Chunked flash in plain torch: a loop over query chunks, online softmax
    over key chunks.  GQA via grouped einsum (no KV repeat)."""
    b, sq, hq, dh = q.shape
    t = k.shape[1]
    hkv = k.shape[2]
    g = hq // hkv
    cq = min(chunk, sq)
    ck = min(chunk_k or chunk, t)
    pad_q = (-sq) % cq
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    nq = q.shape[1] // cq
    pad_k = (-t) % ck
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    nk = k.shape[1] // ck
    kb = k.reshape(b, nk, ck, hkv, dh)
    vb = v.reshape(b, nk, ck, hkv, dh)
    kv_valid = (torch.arange(nk * ck, device=q.device) < t).reshape(nk, ck)

    outs = []
    for iq in range(nq):
        qc = q[:, iq * cq:(iq + 1) * cq]                       # (B,cq,H,D)
        qf = (qc.float() / dh ** 0.5).reshape(b, cq, hkv, g, dh)
        m = torch.full((b, hkv, g, cq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, cq, 1), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hkv, g, cq, dh), dtype=torch.float32,
                          device=q.device)
        for ik in range(nk):
            kc = kb[:, ik].float()
            vc = vb[:, ik].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc)
            mask = kv_valid[ik][None, None, None, None, :]
            if causal:
                qi = iq * cq + torch.arange(cq, device=q.device)[:, None]
                kj = ik * ck + torch.arange(ck, device=q.device)[None, :]
                mask = mask & (qi >= kj)[None, None, None]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            pblk = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)                       # (B,Hkv,G,cq,1)
            l = l * alpha + pblk.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", pblk, vc)
            m = m_new
        out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)  # (B,Hkv,G,cq,D)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, cq, hq, dh))
    return torch.cat(outs, dim=1)[:, :sq]


def _use_kernel(cfg: ModelConfig, x: torch.Tensor) -> bool:
    """``use_pallas`` keeps the reference's name: None means the kernel on
    the accelerator (a CUDA tensor here, a TPU there)."""
    if cfg.use_pallas is None:
        return x.device.type == "cuda"
    return cfg.use_pallas


def attention_prefill(
    p: dict, cfg: ModelConfig, x: torch.Tensor, positions,
) -> tuple[torch.Tensor, KVCache]:
    """Causal attention over the prompt; returns output + KV cache (rope is
    applied before caching, as in the reference).

    The kernel branch uses the fused bucketed-prefill op, which returns the
    cache tensors in the storage dtype (the KV handoff payload for
    disaggregated serving); the plain branch returns K/V uncast, exactly as
    the reference's two branches do."""
    q, k, v = _project_qkv(p, cfg, x, x, positions, positions)
    if _use_kernel(cfg, x):
        out, kc, vc = prefill_attention(
            q, k, v, cache_dtype=dtype_of(cfg.cache_dtype or cfg.compute_dtype),
            use_pallas=True)
        return torch.einsum("bshd,hdm->bsm", out, p["wo"]), KVCache(k=kc, v=vc)
    if x.shape[1] <= cfg.attn_chunk:
        out = _sdpa_full(q, k, v, causal=True)
    else:
        out = _sdpa_chunked(q, k, v, causal=True, chunk=cfg.attn_chunk,
                            chunk_k=cfg.attn_chunk_k)
    return torch.einsum("bshd,hdm->bsm", out, p["wo"]), KVCache(k=k, v=v)


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, device) -> KVCache:
    dt = dtype_of(cfg.cache_dtype or cfg.compute_dtype)
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


def _pos2d(pos: torch.Tensor, b: int) -> torch.Tensor:
    """Normalize pos (scalar or (B,)) to an int (B, 1) matrix."""
    if pos.ndim == 0:
        return pos.reshape(1, 1).expand(b, 1)
    return pos[:, None]


def _cache_write(cache_arr: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor, mode: str) -> torch.Tensor:
    """Write (B,1,H,D) ``new`` at sequence index ``pos`` (scalar or per-batch
    (B,)) of a (B,S,H,D) cache, and return the cache.

    The reference builds a new array (JAX arrays are immutable, the old one
    is donated); the port writes in place, which saves a full cache copy per
    layer per token and leaves the same values: ``dus`` with a scalar pos is
    a slice write, and the one-hot select of every other case puts exactly
    one row per batch lane, which is an indexed write."""
    new = new.to(cache_arr.dtype)
    if mode == "dus" and pos.ndim == 0:
        cache_arr[:, int(pos)] = new[:, 0]
        return cache_arr
    b = cache_arr.shape[0]
    lanes = torch.arange(b, device=cache_arr.device)
    cache_arr[lanes, _pos2d(pos, b)[:, 0]] = new[:, 0]
    return cache_arr


def attention_decode(
    p: dict, cfg: ModelConfig, x: torch.Tensor, cache: KVCache,
    pos: torch.Tensor,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode.  x: (B,1,d).  pos: scalar or per-slot (B,) index.

    Writes K/V at ``pos`` (in place, see ``_cache_write``) and attends over
    cache[<= pos]."""
    b = x.shape[0]
    pos_b = _pos2d(pos, b)
    q, k_t, v_t = _project_qkv(p, cfg, x, x, pos_b, pos_b)
    k = _cache_write(cache.k, k_t, pos, cfg.cache_update)
    v = _cache_write(cache.v, v_t, pos, cfg.cache_update)
    valid = torch.arange(k.shape[1], device=x.device)[None, :] <= pos_b
    kv_mask = valid.expand(b, k.shape[1])
    out = _sdpa_full(
        q, k.to(x.dtype), v.to(x.dtype), causal=False, kv_mask=kv_mask
    )
    return torch.einsum("bshd,hdm->bsm", out, p["wo"]), KVCache(k=k, v=v)
