"""GQA attention: full-sequence (train), prefill (returns cache), decode.

Port of ``repro/models/attention.py``: self-attention, the encoder's
non-causal attention and enc-dec cross-attention.  Full (Sq, Skv)
logits are only materialized when ``S <= cfg.attn_chunk``; beyond that the
chunked path (a loop over query chunks with online softmax over key chunks)
keeps the live logits block at ``attn_chunk^2``.  On CUDA the training
attention goes through the hand-written flash-attention kernel K4 and its
backward (``kernels/flash_attention``), the prefill through the bucketed
prefill kernel (``kernels/prefill``).

Decode reads a cache laid out (B, S, Hkv, Dh), as the reference does.

Split heads (``group``, a ``models/parallel.py::Group`` of more than one
rank): the q heads and ``wo``'s rows are this rank's (their counts come from
the tensors), K/V this rank's share of the KV heads, or, where the KV heads
do not divide over the ranks, all of them, of which each rank reads the
heads its own q heads use (``_local_kv``).  Training and the prefill run K4
and K1 on the local heads.  A decode's cache holds this rank's share of the
sequence for every KV head: each rank attends all heads over its own
positions and the ranks combine their partial softmaxes (``_decode_split``).
Cross-attention splits its heads the same way: training runs K4 on the
local heads over the whole encoder memory (``Group.kv_in`` sums the
memory's gradient over the ranks), the prefill (``cross_prefill``) attends
the local heads over the whole memory and keeps every head on this rank's
share of the memory's sequence, and the decode combines the ranks' partial
softmaxes over that share (``_decode_split``, no write).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..kernels.flash_attention.ops import mha as flash_mha
from ..kernels.prefill.ops import prefill_attention
from .config import ModelConfig
from .layers import apply_rope, dense_init, dtype_of, rms_norm
from .parallel import SOLO, Group

NEG_INF = -1e30

#: ``wo``: the heads' outputs (B, S, H, Dh) to the model width.
_wo = functools.partial(torch.einsum, "bshd,hdm->bsm")


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
                 xkv: torch.Tensor, q_positions, kv_positions,
                 rope: bool = True):
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
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


def _kv_ranges(hq: int, size: int, n_kv: int) -> list[tuple[int, int]]:
    """Each rank's KV heads ``[lo, hi)``: those its ``hq`` q heads read,
    the q heads split over ``size`` ranks in order."""
    group = hq * size // n_kv
    return [((r * hq) // group, ((r + 1) * hq - 1) // group + 1)
            for r in range(size)]


def _local_kv(p: dict, cfg: ModelConfig, group: Group):
    """The projections this rank's q heads need, and None or the index
    that maps each local q head to a column of the projected K/V.

    Where the KV heads split over the ranks with the q heads, this rank's
    share is already the right one and the kernels' own map (q head i reads
    KV head i // (Hq / Hkv)) holds.  Where they do not, every rank holds all
    KV heads: K/V are projected for the range its q heads read only; a map
    that is not uniform over that range (a rank's q heads straddle KV heads
    unevenly) becomes an index that repeats K/V per q head."""
    if group.size == 1:
        return p, None
    hq, hkv = p["wq"].shape[1], p["wk"].shape[1]
    if hkv * group.size == cfg.n_kv_heads:
        return p, None
    lo, hi = _kv_ranges(hq, group.size, hkv)[group.rank]
    p = dict(p)
    for name in ("wk", "wv"):
        p[name] = p[name][:, lo:hi]
    for name in ("bk", "bv"):
        if name in p:
            p[name] = p[name][lo:hi]
    per = hq * group.size // hkv
    need = [(group.rank * hq + i) // per - lo for i in range(hq)]
    n = hi - lo
    if hq % n == 0 and need == [i // (hq // n) for i in range(hq)]:
        return p, None
    return p, torch.tensor(need, device=p["wq"].device)


def _seq_share(c: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's share of a (B, S, ...) cache's sequence, which every
    rank holds whole (the whole sequence where it does not divide over the
    ranks): the placement ``Policy.cache_specs`` gives a decode's cache."""
    s = c.shape[1]
    if group.size == 1 or s % group.size:
        return c
    part = s // group.size
    return c.narrow(1, group.rank * part, part).contiguous()


def _cache_shard(c: torch.Tensor, cfg: ModelConfig, group: Group,
                 hq: int) -> torch.Tensor:
    """From each rank's own KV heads ``c`` (B, S, n, Dh), every KV head on
    this rank's share of the sequence (the whole sequence where it does
    not divide over the ranks): the placement of a decode's cache."""
    n_kv = cfg.n_kv_heads
    n = c.shape[2]
    ranges = ([(r * n, (r + 1) * n) for r in range(group.size)]
              if n * group.size == n_kv else
              _kv_ranges(hq, group.size, n_kv))
    width = max(hi - lo for lo, hi in ranges)
    if n < width:
        c = torch.nn.functional.pad(c, (0, 0, 0, width - n))
    every = group.gather(c, 2)
    heads = []
    for u in range(n_kv):
        r, (lo, _) = next((r, rg) for r, rg in enumerate(ranges)
                          if rg[0] <= u < rg[1])
        heads.append(r * width + u - lo)
    if heads != list(range(every.shape[2])):
        every = every[:, :, heads]
    return _seq_share(every, group)


def attention_train(
    p: dict, cfg: ModelConfig, x: torch.Tensor, positions, *,
    causal: bool = True, xkv: torch.Tensor | None = None, kv_positions=None,
    rope: bool = True, group: Group = SOLO,
) -> torch.Tensor:
    """Full-sequence attention (training, the encoder, cross-attention over
    ``xkv``).  The kernel branch is differentiable through K4's own
    backward kernels, causal or not, with Sq != Skv for cross-attention.
    Under split heads (``group``) the output is this rank's partial sum
    over its heads (its ``wo`` rows)."""
    xkv = x if xkv is None else xkv
    kv_positions = positions if kv_positions is None else kv_positions
    p, expand = _local_kv(p, cfg, group)
    q, k, v = _project_qkv(p, cfg, x, xkv, positions, kv_positions, rope=rope)
    if expand is not None:
        k, v = k[:, :, expand], v[:, :, expand]
    if _use_kernel(cfg, x):
        out = flash_mha(q, k, v, causal=causal, use_pallas=True)
    elif q.shape[1] * k.shape[1] <= cfg.attn_chunk ** 2:
        out = _sdpa_full(q, k, v, causal=causal)
    else:
        out = _sdpa_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                            chunk_k=cfg.attn_chunk_k)
    return group.row_product(_wo, out, p["wo"])


def attention_prefill(
    p: dict, cfg: ModelConfig, x: torch.Tensor, positions, *,
    group: Group = SOLO,
) -> tuple[torch.Tensor, KVCache]:
    """Causal attention over the prompt; returns output + KV cache (rope is
    applied before caching, as in the reference).

    The kernel branch uses the fused bucketed-prefill op, which returns the
    cache tensors in the storage dtype (the KV handoff payload for
    disaggregated serving); the plain branch returns K/V uncast, exactly as
    the reference's two branches do.  Under split heads (``group``) the
    output is this rank's partial sum, and the cache every KV head on this
    rank's share of the sequence (``_cache_shard``)."""
    p, expand = _local_kv(p, cfg, group)
    q, k, v = _project_qkv(p, cfg, x, x, positions, positions)
    if expand is not None:
        k, v = k[:, :, expand], v[:, :, expand]
    if _use_kernel(cfg, x):
        out, k, v = prefill_attention(
            q, k, v, cache_dtype=dtype_of(cfg.cache_dtype or cfg.compute_dtype),
            use_pallas=True)
    elif x.shape[1] <= cfg.attn_chunk:
        out = _sdpa_full(q, k, v, causal=True)
    else:
        out = _sdpa_chunked(q, k, v, causal=True, chunk=cfg.attn_chunk,
                            chunk_k=cfg.attn_chunk_k)
    if group.size > 1:
        if expand is not None:           # one column per KV head
            firsts = [expand.tolist().index(u)
                      for u in range(int(expand.max()) + 1)]
            k, v = k[:, :, firsts], v[:, :, firsts]
        k = _cache_shard(k, cfg, group, q.shape[2])
        v = _cache_shard(v, cfg, group, q.shape[2])
    return group.row_product(_wo, out, p["wo"]), KVCache(k=k, v=v)


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


def _own_write(arr: torch.Tensor, new: torch.Tensor, pos_b: torch.Tensor,
               start: int) -> None:
    """Write (B, 1, ...) ``new`` at each row's position ``pos_b`` (B, 1)
    into ``arr``, which holds the sequence from ``start`` on: in place, in
    the rows whose position falls in it."""
    s_l = arr.shape[1]
    local = pos_b[:, 0] - start
    own = ((local >= 0) & (local < s_l)).reshape(
        (-1,) + (1,) * (arr.ndim - 2))
    at = local.clamp(0, s_l - 1)
    lanes = torch.arange(arr.shape[0], device=arr.device)
    arr[lanes, at] = torch.where(own, new[:, 0].to(arr.dtype), arr[lanes, at])


def _cross_q(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Cross-attention's queries: no rope."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _decode_split(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: KVCache, pos: torch.Tensor | None, group: Group,
                  cross: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Decode of split heads over a cache that holds this rank's share of
    the sequence (``Policy.cache_specs``) for every KV head.  The tokens'
    queries are gathered over the ranks ((B, T, H, Dh)); self-attention
    (one token) gathers k and v too, and the rank that owns position
    ``pos`` writes them; cross-attention writes nothing, and every row of
    the share is valid (no ``cross_len``, as the whole decode reads the
    whole cache).  Each rank attends every head over its own positions, and
    the ranks combine their partial softmaxes by all-reduces of the row
    maxima, the sums and the weighted values.  Returns this rank's partial
    sum over its own heads (its ``wo`` rows)."""
    b, t = x.shape[:2]
    s_l = cache.k.shape[1]
    start = group.rank * s_l
    if cross:
        q = _cross_q(p, cfg, x)
        valid = torch.ones((b, s_l), dtype=torch.bool, device=x.device)
    else:
        pos_b = _pos2d(pos, b)
        q, k_t, v_t = _project_qkv(p, cfg, x, x, pos_b, pos_b)
        if k_t.shape[2] != cfg.n_kv_heads:
            k_t, v_t = group.gather(k_t, 2), group.gather(v_t, 2)
        _own_write(cache.k, k_t, pos_b, start)
        _own_write(cache.v, v_t, pos_b, start)
        valid = (start + torch.arange(s_l, device=x.device))[None, :] \
            <= pos_b
    hq = q.shape[2]
    q = group.gather(q, 2)
    h, hkv, dh = q.shape[2], cache.k.shape[2], q.shape[3]
    qg = q.reshape(b, t, hkv, h // hkv, dh)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                      cache.k.to(x.dtype)).float() / dh ** 0.5
    sc = torch.where(valid[:, None, None, None, :], sc, NEG_INF)
    # The whole decode's softmax over the ranks' positions: its maximum and
    # sum all-reduced, its probabilities rounded to the compute dtype as
    # the whole decode rounds them, the weighted values summed in f32 and
    # rounded once.
    e = torch.exp(sc - group.max(sc.amax(dim=-1, keepdim=True)))
    p_att = (e / group.sum(e.sum(dim=-1, keepdim=True))).to(x.dtype)
    out = group.sum(torch.einsum("bhgqk,bkhd->bhgqd", p_att.float(),
                                 cache.v.to(x.dtype).float())).to(x.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, t, h, dh)
    out = out[:, :, group.rank * hq:(group.rank + 1) * hq]
    return group.row_product(_wo, out, p["wo"]), cache


def attention_decode(
    p: dict, cfg: ModelConfig, x: torch.Tensor, cache: KVCache,
    pos: torch.Tensor | None, *, cross: bool = False,
    cross_len: int | torch.Tensor | None = None, group: Group = SOLO,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode.  x: (B,1,d).  pos: scalar or per-slot (B,) index.

    Self-attention writes K/V at ``pos`` (in place, see ``_cache_write``)
    and attends over cache[<= pos].  Cross-attention (enc-dec) reads the
    encoder memory's K/V from the cache, writes nothing and attends over
    cache[< cross_len] (the whole cache when ``cross_len`` is None); its
    query is not rope'd, and x may hold any number of tokens.  Split heads
    (``group``) decode over a sequence-split cache (``_decode_split``; a
    cross decode there takes the whole share, as ``cross_len`` None)."""
    if group.size > 1:
        if cross and cross_len is not None:
            raise ValueError("a split cross decode reads its whole share: "
                             "cross_len must be None")
        return _decode_split(p, cfg, x, cache, pos, group, cross=cross)
    b = x.shape[0]
    if cross:
        q = _cross_q(p, cfg, x)
        k, v = cache.k, cache.v
        n = k.shape[1] if cross_len is None else cross_len
        valid = torch.arange(k.shape[1], device=x.device) < torch.as_tensor(
            n, device=x.device)
    else:
        pos_b = _pos2d(pos, b)
        q, k_t, v_t = _project_qkv(p, cfg, x, x, pos_b, pos_b)
        k = _cache_write(cache.k, k_t, pos, cfg.cache_update)
        v = _cache_write(cache.v, v_t, pos, cfg.cache_update)
        cache = KVCache(k=k, v=v)
        valid = torch.arange(k.shape[1], device=x.device)[None, :] <= pos_b
    kv_mask = valid.expand(b, k.shape[1])
    out = _sdpa_full(
        q, k.to(x.dtype), v.to(x.dtype), causal=False, kv_mask=kv_mask
    )
    return torch.einsum("bshd,hdm->bsm", out, p["wo"]), cache


def cross_kv(p: dict, cfg: ModelConfig, memory: torch.Tensor) -> KVCache:
    """Project encoder memory to K/V once (cached for the whole decode).
    The keys take ``k_norm`` where the layer has one; no rope."""
    k = torch.einsum("bsd,dhk->bshk", memory, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return KVCache(k=k, v=v)


def cross_prefill(
    p: dict, cfg: ModelConfig, x: torch.Tensor, memory: torch.Tensor, *,
    group: Group = SOLO,
) -> tuple[torch.Tensor, KVCache]:
    """A prefill's cross-attention: K/V projected once from the memory
    (``cross_kv``, the layer's "cross" cache) and ``x`` attending all of
    it, as the reference's ``attention_decode(cross=True)`` with no
    ``cross_len``.  Under split heads the output is this rank's partial
    sum over its heads, attended over the whole memory, and the cache every
    KV head on this rank's share of the memory's sequence
    (``_cache_shard``)."""
    if group.size == 1:
        kv = cross_kv(p, cfg, memory)
        return attention_decode(p, cfg, x, kv, None, cross=True)[0], kv
    p, expand = _local_kv(p, cfg, group)
    kv = cross_kv(p, cfg, memory)
    k, v = kv.k, kv.v
    q = _cross_q(p, cfg, x)
    if expand is not None:
        k, v = k[:, :, expand], v[:, :, expand]
    out = _sdpa_full(q, k.to(x.dtype), v.to(x.dtype), causal=False)
    return group.row_product(_wo, out, p["wo"]), KVCache(
        k=_cache_shard(kv.k, cfg, group, q.shape[2]),
        v=_cache_shard(kv.v, cfg, group, q.shape[2]))
