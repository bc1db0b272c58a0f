"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Port of ``repro/models/mla.py``.  Queries go through a low-rank bottleneck
(q_lora); keys/values share a compressed latent c_kv (kv_lora=512) plus a
single shared rope key stream (qk_rope=64).  The decode cache stores only
(c_kv, k_rope) per token — (512+64) values/layer instead of 2*H*Dh — which
is the paper's point.

Decode runs in the *absorbed* form: W_UK folds into the query and W_UV into
the output so attention happens directly in latent space; nothing of size
(S, H, Dh) is materialized against the cache.  The cache is written in
place (``attention._cache_write``), where the reference builds a new array;
the values are the same.

Plain tensor code, no kernel, as in the reference (its MLA attention is
plain einsums): its q/k head dim (nope + rope, 192 at full width) is not
one of K4's compiled head dims.

Split heads (``group``, a ``models/parallel.py::Group`` of more than one
rank; ``transformer.apply_layer`` gives it where the policy splits
``wuq``'s heads over ``model``): ``wuq``, ``wuk``, ``wuv`` and ``wo``'s
rows are this rank's heads; the front end (``wdq`` gathered whole,
``q_norm`` over the whole q_lora width, ``wdkv``, ``wkr``, ``kv_norm``) is
computed whole on every rank, each using it for its own heads.  Training
and the prefill attend this rank's heads and return its partial sum over
them (``Group.row_product``); the prefill's latent cache, computed whole,
keeps this rank's share of the sequence (``attention._seq_share``).  The
absorbed decode runs over that share and combines the ranks' partial
softmaxes as ``attention._decode_split`` does; the cache is never
gathered.
"""

from __future__ import annotations

import dataclasses

import torch

from .attention import _cache_write, _own_write, _pos2d, _seq_share
from .config import ModelConfig
from .layers import apply_rope, dense_init, dtype_of, rms_norm
from .parallel import SOLO, Group

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MLACache:
    c_kv: torch.Tensor     # (B, S, kv_lora)
    k_rope: torch.Tensor   # (B, S, rope_dim)


def init_mla(gen: torch.Generator, cfg: ModelConfig) -> dict:
    m = cfg.mla
    dt = dtype_of(cfg.param_dtype)
    h = cfg.n_q_heads
    dev = gen.device
    return {
        "wdq": dense_init(gen, (cfg.d_model, m.q_lora_rank), dt),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dt, device=dev),
        "wuq": dense_init(
            gen, (m.q_lora_rank, h, m.qk_nope_head_dim + m.qk_rope_head_dim),
            dt),
        "wdkv": dense_init(gen, (cfg.d_model, m.kv_lora_rank), dt),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dt, device=dev),
        "wkr": dense_init(gen, (cfg.d_model, m.qk_rope_head_dim), dt),
        "wuk": dense_init(gen, (m.kv_lora_rank, h, m.qk_nope_head_dim), dt),
        "wuv": dense_init(gen, (m.kv_lora_rank, h, m.v_head_dim), dt),
        "wo": dense_init(gen, (h, m.v_head_dim, cfg.d_model), dt),
    }


def _kv_latents(p: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """The compressed kv latent and the rope'd shared key: what the cache
    holds."""
    c_kv = rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["wkr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _latents(p: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """Shared front end: q (rope'd), compressed kv latent, rope'd shared
    key."""
    m = cfg.mla
    cq = rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wuq"])
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    c_kv, k_rope = _kv_latents(p, cfg, x, positions)
    return q_nope, q_rope, c_kv, k_rope


def _scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return 1.0 / (m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5


def _wo(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``wo``: the heads' outputs (B, S, H, Dv) to the model width."""
    return torch.einsum("bshk,hkd->bsd", out, wo)


def mla_train(
    p: dict, cfg: ModelConfig, x: torch.Tensor, positions, *,
    causal: bool = True, group: Group = SOLO,
) -> torch.Tensor:
    """Naive (decompressed) form for train/prefill — chunked over queries
    (``attn_chunk`` rows at a time, each chunk its own causal mask).  Under
    split heads (``group``) the output is this rank's partial sum over its
    heads (its ``wo`` rows)."""
    q_nope, q_rope, c_kv, k_rope = _latents(p, cfg, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wuk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wuv"])
    scale = _scale(cfg)
    b, s, h, _ = q_nope.shape
    cq = min(cfg.attn_chunk, s)
    pad = (-s) % cq
    if pad:
        q_nope = torch.nn.functional.pad(q_nope, (0, 0, 0, 0, 0, pad))
        q_rope = torch.nn.functional.pad(q_rope, (0, 0, 0, 0, 0, pad))
    outs = []
    for iq in range(0, s + pad, cq):
        sc = (torch.einsum("bqhk,bshk->bhqs", q_nope[:, iq:iq + cq], k_nope)
              + torch.einsum("bqhk,bsk->bhqs", q_rope[:, iq:iq + cq], k_rope)
              ).float() * scale
        if causal:
            qi = iq + torch.arange(cq, device=x.device)[:, None]
            kj = torch.arange(s, device=x.device)[None, :]
            sc = torch.where((qi >= kj)[None, None], sc, NEG_INF)
        attn = torch.softmax(sc, dim=-1).to(x.dtype)
        outs.append(torch.einsum("bhqs,bshk->bqhk", attn, v))
    out = torch.cat(outs, dim=1)[:, :s]
    return group.row_product(_wo, out, p["wo"])


def mla_prefill(
    p: dict, cfg: ModelConfig, x: torch.Tensor, positions, *,
    group: Group = SOLO,
) -> tuple[torch.Tensor, MLACache]:
    """The causal output and the latent cache; under split heads this
    rank's partial sum, and the cache's share of the sequence that
    ``Policy.cache_specs`` gives this rank."""
    out = mla_train(p, cfg, x, positions, causal=True, group=group)
    c_kv, k_rope = _kv_latents(p, cfg, x, positions)
    return out, MLACache(c_kv=_seq_share(c_kv, group),
                         k_rope=_seq_share(k_rope, group))


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int, device) -> MLACache:
    m = cfg.mla
    dt = dtype_of(cfg.cache_dtype or cfg.compute_dtype)
    return MLACache(
        c_kv=torch.zeros((batch, seq, m.kv_lora_rank), dtype=dt,
                         device=device),
        k_rope=torch.zeros((batch, seq, m.qk_rope_head_dim), dtype=dt,
                           device=device),
    )


def _decode_split(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: MLACache, pos: torch.Tensor, group: Group
                  ) -> tuple[torch.Tensor, MLACache]:
    """The absorbed decode of split heads over a latent cache that holds
    this rank's share of the sequence.  The rank that owns ``pos`` writes
    the token's latents; the absorbed queries of every head ((B, 1, H,
    kv_lora) and (B, 1, H, rope)) are gathered; each rank scores every head
    over its own positions, and the ranks combine their partial softmaxes
    by all-reduces of the row maxima, the sums and the latent contexts
    (summed in f32, rounded once).  Each rank then absorbs ``wuv`` into its
    own heads' contexts and returns its partial sum over them."""
    b = x.shape[0]
    pos_b = _pos2d(pos, b)
    q_nope, q_rope, c_kv_t, k_rope_t = _latents(p, cfg, x, pos_b)
    s_l = cache.c_kv.shape[1]
    start = group.rank * s_l
    _own_write(cache.c_kv, c_kv_t, pos_b, start)
    _own_write(cache.k_rope, k_rope_t, pos_b, start)
    hq = q_nope.shape[2]
    q_lat = group.gather(torch.einsum("bqhk,rhk->bqhr", q_nope, p["wuk"]), 2)
    q_rope = group.gather(q_rope, 2)
    ckv = cache.c_kv.to(x.dtype)
    krp = cache.k_rope.to(x.dtype)
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
              + torch.einsum("bqhk,bsk->bhqs", q_rope, krp)
              ).float() * _scale(cfg)
    valid = (start + torch.arange(s_l, device=x.device))[None, :] <= pos_b
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    e = torch.exp(logits - group.max(logits.amax(dim=-1, keepdim=True)))
    attn = (e / group.sum(e.sum(dim=-1, keepdim=True))).to(x.dtype)
    ctx_lat = group.sum(torch.einsum("bhqs,bsr->bqhr", attn.float(),
                                     ckv.float())).to(x.dtype)
    ctx_lat = ctx_lat[:, :, group.rank * hq:(group.rank + 1) * hq]
    out = torch.einsum("bqhr,rhk->bqhk", ctx_lat, p["wuv"])
    return group.row_product(_wo, out, p["wo"]), cache


def mla_decode(
    p: dict, cfg: ModelConfig, x: torch.Tensor, cache: MLACache,
    pos: torch.Tensor, *, group: Group = SOLO,
) -> tuple[torch.Tensor, MLACache]:
    """Absorbed-form decode: attention entirely in the kv_lora latent.
    Writes the token's latents at ``pos`` in place; the latent cache is
    cast to ``x.dtype`` before the absorbed products and the scores to f32,
    where the reference casts them.  Split heads (``group``) decode over a
    sequence-split cache (``_decode_split``)."""
    if group.size > 1:
        return _decode_split(p, cfg, x, cache, pos, group)
    b = x.shape[0]
    pos_b = _pos2d(pos, b)
    q_nope, q_rope, c_kv_t, k_rope_t = _latents(p, cfg, x, pos_b)
    cache = MLACache(
        c_kv=_cache_write(cache.c_kv, c_kv_t, pos, cfg.cache_update),
        k_rope=_cache_write(cache.k_rope, k_rope_t, pos, cfg.cache_update),
    )
    # Absorb W_UK into the query: q_lat (B,1,H,kv_lora).
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, p["wuk"])
    ckv = cache.c_kv.to(x.dtype)
    krp = cache.k_rope.to(x.dtype)
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
              + torch.einsum("bqhk,bsk->bhqs", q_rope, krp)
              ).float() * _scale(cfg)
    valid = torch.arange(cache.c_kv.shape[1], device=x.device)[None, :] \
        <= pos_b                                                  # (B, S)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    attn = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhqs,bsr->bqhr", attn, ckv)         # (B,1,H,R)
    out = torch.einsum("bqhr,rhk->bqhk", ctx_lat, p["wuv"])     # absorb W_UV
    return torch.einsum("bqhk,hkd->bqd", out, p["wo"]), cache
