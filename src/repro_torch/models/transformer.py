"""Pattern-period layer stacks: init + apply, dense attention+MLP layers.

Port of ``repro/models/transformer.py``.  The stack is ``prefix_pattern``
(unrolled layers) followed by ``n_periods`` repetitions of
``layer_pattern``; stacked period params/caches carry a leading
``n_periods`` axis on every leaf, exactly as the reference lays them out, so
bridged weights load as they are.  The reference's ``lax.scan`` over that
axis becomes a Python loop, and its ``jax.checkpoint`` of each period
(``remat``) a ``torch.utils.checkpoint`` of each period.

Modes: "train" (no cache), "prefill" (returns caches) and "decode"
(consumes and returns caches, one token).  Mixers: attention and mamba
(``models/mamba.py``; its cache is a ``MambaCache`` of conv window and
state, with no sequence axis).  MLPs: dense, MoE (``models/moe.py``: the
capacity-routed ``apply_moe`` in train and prefill, the dropless
``apply_moe_dense`` in decode, as in the reference) or none.  Every apply
returns the MoE load-balancing aux loss beside ``x``, summed in the
reference's layer order.  MLA layers, enc-dec cross-attention and
``remat_policy="dots"`` raise ``NotImplementedError`` naming the port slice
that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..tree import tree_flatten, tree_unflatten
from .attention import (
    attention_decode,
    attention_prefill,
    attention_train,
    init_attention,
    init_kv_cache,
)
from .config import LayerSpec, ModelConfig
from .layers import apply_mlp, apply_norm, init_mlp, init_norm
from .mamba import init_mamba, init_mamba_cache, mamba_decode, mamba_train
from .moe import apply_moe, apply_moe_dense, init_moe

_LATER = {
    "mla": "MLA layers come with the port's remaining-configs slice "
           "(MLA, enc-dec)",
    "cross": "enc-dec cross-attention comes with the port's remaining-configs "
             "slice (MLA, enc-dec)",
    "dots": "remat_policy='dots' (save the matmul outputs, recompute the "
            "rest) comes with the port's distribution-and-tooling slice",
}


def check_layer(spec: LayerSpec) -> None:
    """Raise for a layer this slice of the port does not run."""
    if spec.mixer not in ("attn", "mamba"):
        raise NotImplementedError(_LATER[spec.mixer])
    if spec.cross_attn:
        raise NotImplementedError(_LATER["cross"])


# --------------------------------------------------------------------- layer init
def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec) -> dict:
    check_layer(spec)
    p: dict[str, Any] = {"norm1": init_norm(cfg, gen.device)}
    if spec.mixer == "attn":
        p["attn"] = init_attention(gen, cfg)
    else:
        p["mamba"] = init_mamba(gen, cfg)
    if spec.mlp == "dense":
        p["norm2"] = init_norm(cfg, gen.device)
        p["mlp"] = init_mlp(gen, cfg)
    elif spec.mlp == "moe":
        p["norm2"] = init_norm(cfg, gen.device)
        p["moe"] = init_moe(gen, cfg)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int,
                     device) -> dict:
    check_layer(spec)
    if spec.mixer == "mamba":
        return {"self": init_mamba_cache(cfg, batch, device)}
    return {"self": init_kv_cache(cfg, batch, seq, device)}


# -------------------------------------------------------------------- layer apply
def apply_layer(
    p: dict, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor, *,
    mode: str, positions=None, cache: dict | None = None, pos=None,
    causal: bool = True, capacities=None,
):
    """Returns (x, new_cache, aux): the cache is None in train mode; aux is
    the MoE layer's load-balancing loss, and the number 0.0 for other
    layers and in decode (adding it changes no sum, and it launches
    nothing)."""
    check_layer(spec)
    h = apply_norm(cfg, p["norm1"], x)
    c = None
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode: {mode!r}")
    if spec.mixer == "mamba":
        if mode == "decode":
            a, c = mamba_decode(p["mamba"], cfg, h, cache["self"])
        else:
            a, c = mamba_train(p["mamba"], cfg, h)
            c = c if mode == "prefill" else None
    elif mode == "train":
        a = attention_train(p["attn"], cfg, h, positions, causal=causal)
    elif mode == "prefill":
        a, c = attention_prefill(p["attn"], cfg, h, positions)
    else:
        a, c = attention_decode(p["attn"], cfg, h, cache["self"], pos)
    x = x + a
    aux = 0.0
    if spec.mlp == "dense":
        x = x + apply_mlp(p["mlp"], apply_norm(cfg, p["norm2"], x))
    elif spec.mlp == "moe":
        h = apply_norm(cfg, p["norm2"], x)
        if mode == "decode":
            mo, _ = apply_moe_dense(p["moe"], cfg, h)
        else:
            mo, aux = apply_moe(p["moe"], cfg, h, capacities)
        x = x + mo
    return x, (None if c is None else {"self": c}), aux


# -------------------------------------------------------------------- stack
def _fields(cache) -> dict[str, Any]:
    """A cache dataclass's (``KVCache``, ``MambaCache``) tensors by name."""
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}


def _stack(items: list) -> Any:
    """Stack per-period pytrees (dicts / cache dataclasses of tensors) on a
    new leading axis — the layout ``lax.scan`` gives the reference."""
    first = items[0]
    if isinstance(first, dict):
        return {key: _stack([it[key] for it in items]) for key in first}
    if dataclasses.is_dataclass(first):
        return type(first)(**{name: torch.stack([getattr(it, name)
                                                 for it in items])
                              for name in _fields(first)})
    return torch.stack(items)


def _index(tree: Any, i: int) -> Any:
    """Period ``i`` of a stacked pytree (views: writes reach the stack)."""
    if isinstance(tree, dict):
        return {key: _index(val, i) for key, val in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{name: t[i] for name, t in _fields(tree).items()})
    return tree[i]


def _init_stacked(gen: torch.Generator, cfg: ModelConfig,
                  spec: LayerSpec) -> dict:
    """``n_periods`` draws of one layer, stacked on a leading axis as
    ``_stack`` lays them out, each written into its slot as it is drawn:
    the peak holds the stack and one layer, where stacking a list of every
    period would hold the stack twice."""
    leaves, treedef = tree_flatten(init_layer(gen, cfg, spec))
    out = [torch.empty((cfg.n_periods,) + tuple(leaf.shape), dtype=leaf.dtype,
                       device=leaf.device) for leaf in leaves]
    for t in range(cfg.n_periods):
        if t:
            leaves = tree_flatten(init_layer(gen, cfg, spec))[0]
        for slot, leaf in zip(out, leaves, strict=True):
            slot[t] = leaf
        del leaves
    return tree_unflatten(treedef, out)


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> dict:
    out: dict[str, Any] = {}
    if cfg.prefix_pattern:
        out["prefix"] = [init_layer(gen, cfg, s) for s in cfg.prefix_pattern]
    out["periods"] = {f"pos{i}": _init_stacked(gen, cfg, spec)
                      for i, spec in enumerate(cfg.layer_pattern)}
    return out


def init_stack_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    out: dict[str, Any] = {}
    if cfg.prefix_pattern:
        out["prefix"] = [init_layer_cache(cfg, s, batch, seq, device)
                         for s in cfg.prefix_pattern]
    periods = {}
    for i, spec in enumerate(cfg.layer_pattern):
        single = init_layer_cache(cfg, spec, batch, seq, device)["self"]
        periods[f"pos{i}"] = {"self": type(single)(**{
            name: torch.zeros((cfg.n_periods,) + tuple(t.shape),
                              dtype=t.dtype, device=device)
            for name, t in _fields(single).items()})}
    out["periods"] = periods
    return out


def _unbind(tree: Any) -> list:
    """A stacked period pytree as one pytree per period.  ``unbind``'s
    backward stacks the per-period gradients in one op, where indexing
    period by period would add a zero-padded full-size gradient per
    period."""
    leaves, treedef = tree_flatten(tree)
    parts = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [p[t] for p in parts])
            for t in range(len(parts[0]))]


def _apply_stack_train(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       positions, causal: bool, remat: bool, capacities):
    if remat and cfg.remat_policy == "dots":
        raise NotImplementedError(_LATER["dots"])
    aux = 0.0
    for i, spec in enumerate(cfg.prefix_pattern):
        x, _, a = apply_layer(params["prefix"][i], cfg, spec, x, mode="train",
                              positions=positions, causal=causal,
                              capacities=capacities)
        aux = aux + a

    def body(h: torch.Tensor, aux_acc, per_params: dict):
        # The aux sum enters and leaves the checkpointed body as an argument
        # and an output, as the scan carry does in the reference: its
        # gradient survives the checkpoint, and the sum runs in the
        # reference's layer order.
        for i, spec in enumerate(cfg.layer_pattern):
            h, _, a = apply_layer(per_params[f"pos{i}"], cfg, spec, h,
                                  mode="train", positions=positions,
                                  causal=causal, capacities=capacities)
            aux_acc = aux_acc + a
        return h, aux_acc

    for per_params in _unbind(params["periods"]):
        if remat:
            # The reference's jax.checkpoint of the scan body: only the
            # period's input is kept; its forward runs again in the backward.
            x, aux = checkpoint(body, x, aux, per_params, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = body(x, aux, per_params)
    return x, aux


def apply_stack(
    params: dict, cfg: ModelConfig, x: torch.Tensor, *,
    mode: str, positions=None, caches: dict | None = None, pos=None,
    causal: bool = True, capacities=None, remat: bool = True,
):
    """Returns (x, new_caches, aux): the caches are None in train mode; aux
    is the sum of the MoE layers' load-balancing losses in layer order (the
    number 0.0 without any).  In
    decode mode the caches are updated in place (see
    ``attention._cache_write``) and returned.  ``capacities`` are the MoE
    layers' per-expert capacities (train and prefill; None: uniform).
    ``remat`` (train mode) recomputes each period's forward in the backward
    instead of keeping its activations."""
    if mode == "train":
        x, aux = _apply_stack_train(params, cfg, x, positions, causal, remat,
                                    capacities)
        return x, None, aux
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode: {mode!r}")
    aux = 0.0
    new_prefix = []
    for i, spec in enumerate(cfg.prefix_pattern):
        c = caches["prefix"][i] if caches is not None else None
        x, nc, a = apply_layer(params["prefix"][i], cfg, spec, x, mode=mode,
                               positions=positions, cache=c, pos=pos,
                               capacities=capacities)
        aux = aux + a
        new_prefix.append(nc)
    per_period = []
    for t in range(cfg.n_periods):
        ncs = {}
        for i, spec in enumerate(cfg.layer_pattern):
            key = f"pos{i}"
            c = (_index(caches["periods"][key], t)
                 if mode == "decode" else None)
            x, ncs[key], a = apply_layer(
                _index(params["periods"][key], t), cfg, spec, x, mode=mode,
                positions=positions, cache=c, pos=pos, capacities=capacities)
            aux = aux + a
        per_period.append(ncs)
    if mode == "decode":
        out_caches = caches
    else:
        out_caches = {"periods": _stack(per_period)}
        if cfg.prefix_pattern:
            out_caches["prefix"] = new_prefix
    return x, out_caches, aux
