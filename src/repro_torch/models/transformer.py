"""Pattern-period layer stacks: init + apply, dense attention+MLP layers.

Port of ``repro/models/transformer.py``.  The stack is ``prefix_pattern``
(unrolled layers) followed by ``n_periods`` repetitions of
``layer_pattern``; stacked period params/caches carry a leading
``n_periods`` axis on every leaf, exactly as the reference lays them out, so
bridged weights load as they are.  The reference's ``lax.scan`` over that
axis becomes a Python loop.

Modes: "prefill" (returns caches) and "decode" (consumes and returns caches,
one token).  Mamba, MLA and MoE layers and ``mode="train"`` raise
``NotImplementedError`` naming the port slice that brings them.
"""

from __future__ import annotations

from typing import Any

import torch

from .attention import (
    KVCache,
    attention_decode,
    attention_prefill,
    init_attention,
    init_kv_cache,
)
from .config import LayerSpec, ModelConfig
from .layers import apply_mlp, apply_norm, init_mlp, init_norm

_LATER = {
    "mamba": "mamba layers come with the port's mamba slice (kernel K5, "
             "ssd_scan)",
    "mla": "MLA layers come with the port's remaining-configs slice "
           "(MoE, MLA, enc-dec)",
    "moe": "MoE layers come with the port's remaining-configs slice "
           "(MoE, MLA, enc-dec)",
    "cross": "enc-dec cross-attention comes with the port's remaining-configs "
             "slice (MoE, MLA, enc-dec)",
    "train": "mode='train' comes with the port's training slice (kernel K4 "
             "plus a backward kernel)",
}


def check_layer(spec: LayerSpec) -> None:
    """Raise for a layer this slice of the port does not run."""
    if spec.mixer != "attn":
        raise NotImplementedError(_LATER[spec.mixer])
    if spec.mlp == "moe":
        raise NotImplementedError(_LATER["moe"])
    if spec.cross_attn:
        raise NotImplementedError(_LATER["cross"])


# --------------------------------------------------------------------- layer init
def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec) -> dict:
    check_layer(spec)
    p: dict[str, Any] = {"norm1": init_norm(cfg, gen.device),
                         "attn": init_attention(gen, cfg)}
    if spec.mlp == "dense":
        p["norm2"] = init_norm(cfg, gen.device)
        p["mlp"] = init_mlp(gen, cfg)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int,
                     device) -> dict:
    check_layer(spec)
    return {"self": init_kv_cache(cfg, batch, seq, device)}


# -------------------------------------------------------------------- layer apply
def apply_layer(
    p: dict, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor, *,
    mode: str, positions=None, cache: dict | None = None, pos=None,
):
    """Returns (x, new_cache)."""
    check_layer(spec)
    h = apply_norm(cfg, p["norm1"], x)
    if mode == "prefill":
        a, c = attention_prefill(p["attn"], cfg, h, positions)
    elif mode == "decode":
        a, c = attention_decode(p["attn"], cfg, h, cache["self"], pos)
    else:
        raise NotImplementedError(_LATER["train"])
    x = x + a
    if spec.mlp == "dense":
        x = x + apply_mlp(p["mlp"], apply_norm(cfg, p["norm2"], x))
    return x, {"self": c}


# -------------------------------------------------------------------- stack
def _stack(items: list) -> Any:
    """Stack per-period pytrees (dicts / KVCache of tensors) on a new
    leading axis — the layout ``lax.scan`` gives the reference."""
    first = items[0]
    if isinstance(first, dict):
        return {key: _stack([it[key] for it in items]) for key in first}
    if isinstance(first, KVCache):
        return KVCache(k=torch.stack([it.k for it in items]),
                       v=torch.stack([it.v for it in items]))
    return torch.stack(items)


def _index(tree: Any, i: int) -> Any:
    """Period ``i`` of a stacked pytree (views: writes reach the stack)."""
    if isinstance(tree, dict):
        return {key: _index(val, i) for key, val in tree.items()}
    if isinstance(tree, KVCache):
        return KVCache(k=tree.k[i], v=tree.v[i])
    return tree[i]


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> dict:
    out: dict[str, Any] = {}
    if cfg.prefix_pattern:
        out["prefix"] = [init_layer(gen, cfg, s) for s in cfg.prefix_pattern]
    out["periods"] = {
        f"pos{i}": _stack([init_layer(gen, cfg, spec)
                           for _ in range(cfg.n_periods)])
        for i, spec in enumerate(cfg.layer_pattern)
    }
    return out


def init_stack_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    out: dict[str, Any] = {}
    if cfg.prefix_pattern:
        out["prefix"] = [init_layer_cache(cfg, s, batch, seq, device)
                         for s in cfg.prefix_pattern]
    periods = {}
    for i, spec in enumerate(cfg.layer_pattern):
        single = init_layer_cache(cfg, spec, batch, seq, device)["self"]
        shape = (cfg.n_periods,) + tuple(single.k.shape)
        periods[f"pos{i}"] = {"self": KVCache(
            k=torch.zeros(shape, dtype=single.k.dtype, device=device),
            v=torch.zeros(shape, dtype=single.v.dtype, device=device))}
    out["periods"] = periods
    return out


def apply_stack(
    params: dict, cfg: ModelConfig, x: torch.Tensor, *,
    mode: str, positions=None, caches: dict | None = None, pos=None,
):
    """Returns (x, new_caches).  In decode mode the caches are updated in
    place (see ``attention._cache_write``) and returned."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(_LATER["train"])
    new_prefix = []
    for i, spec in enumerate(cfg.prefix_pattern):
        c = caches["prefix"][i] if caches is not None else None
        x, nc = apply_layer(params["prefix"][i], cfg, spec, x, mode=mode,
                            positions=positions, cache=c, pos=pos)
        new_prefix.append(nc)
    per_period = []
    for t in range(cfg.n_periods):
        ncs = {}
        for i, spec in enumerate(cfg.layer_pattern):
            key = f"pos{i}"
            c = (_index(caches["periods"][key], t)
                 if mode == "decode" else None)
            x, ncs[key] = apply_layer(
                _index(params["periods"][key], t), cfg, spec, x, mode=mode,
                positions=positions, cache=c, pos=pos)
        per_period.append(ncs)
    if mode == "decode":
        out_caches = caches
    else:
        out_caches = {"periods": _stack(per_period)}
        if cfg.prefix_pattern:
            out_caches["prefix"] = new_prefix
    return x, out_caches
