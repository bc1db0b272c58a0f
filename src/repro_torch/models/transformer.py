"""Pattern-period layer stacks: init + apply.

Port of ``repro/models/transformer.py``.  The stack is ``prefix_pattern``
(unrolled layers, e.g. deepseek's first dense layer) followed by
``n_periods`` repetitions of ``layer_pattern``; stacked period params/caches
carry a leading ``n_periods`` axis on every leaf, exactly as the reference
lays them out, so bridged weights load as they are.  The reference's
``lax.scan`` over that axis becomes a Python loop, and its
``jax.checkpoint`` of each period (``remat``) a ``torch.utils.checkpoint``
of each period.  Every init and apply takes the stack's ``pattern``,
``prefix`` and ``n_periods`` (the config's by default), so one model holds
a decoder stack and an encoder stack (``models/model.py``).

Modes: "train" (no cache), "prefill" (returns caches) and "decode"
(consumes and returns caches, one token).  Mixers: attention, MLA
(``models/mla.py``; its cache is an ``MLACache`` of the compressed latent
and the shared rope key) and mamba (``models/mamba.py``; its cache is a
``MambaCache`` of conv window and state, with no sequence axis).  Decoder
layers of enc-dec models add cross-attention over the encoder memory
(``LayerSpec.cross_attn``): through K4 in training, and in prefill and
decode through ``attention_decode(cross=True)`` against K/V projected once
from the memory (``cross_kv``, the layer's "cross" cache).  MLPs: dense,
MoE (``models/moe.py``: the capacity-routed ``apply_moe`` in train and
prefill, the dropless ``apply_moe_dense`` in decode, as in the reference)
or none.  Every apply returns the MoE load-balancing aux loss beside ``x``,
summed in the reference's layer order.  ``remat_policy="dots"`` raises
``NotImplementedError`` naming the port slice that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..tree import tree_flatten, tree_unflatten
from .attention import (
    KVCache,
    attention_decode,
    attention_prefill,
    attention_train,
    init_attention,
    init_kv_cache,
)
from .config import LayerSpec, ModelConfig
from .layers import apply_mlp, apply_norm, init_mlp, init_norm, rms_norm
from .mamba import init_mamba, init_mamba_cache, mamba_decode, mamba_train
from .mla import init_mla, init_mla_cache, mla_decode, mla_prefill, mla_train
from .moe import apply_moe, apply_moe_dense, init_moe

_LATER = {
    "dots": "remat_policy='dots' (save the matmul outputs, recompute the "
            "rest) comes with the port's distribution-and-tooling slice",
}


# --------------------------------------------------------------------- layer init
def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec) -> dict:
    p: dict[str, Any] = {"norm1": init_norm(cfg, gen.device)}
    if spec.mixer == "attn":
        p["attn"] = init_attention(gen, cfg)
    elif spec.mixer == "mla":
        p["mla"] = init_mla(gen, cfg)
    elif spec.mixer == "mamba":
        p["mamba"] = init_mamba(gen, cfg)
    else:
        raise ValueError(spec.mixer)
    if spec.cross_attn:
        p["norm_cross"] = init_norm(cfg, gen.device)
        p["cross"] = init_attention(gen, cfg)
    if spec.mlp == "dense":
        p["norm2"] = init_norm(cfg, gen.device)
        p["mlp"] = init_mlp(gen, cfg)
    elif spec.mlp == "moe":
        p["norm2"] = init_norm(cfg, gen.device)
        p["moe"] = init_moe(gen, cfg)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int,
                     device, cross_seq: int | None = None) -> dict:
    if spec.mixer == "attn":
        c = {"self": init_kv_cache(cfg, batch, seq, device)}
    elif spec.mixer == "mla":
        c = {"self": init_mla_cache(cfg, batch, seq, device)}
    elif spec.mixer == "mamba":
        c = {"self": init_mamba_cache(cfg, batch, device)}
    else:
        raise ValueError(spec.mixer)
    if spec.cross_attn:
        c["cross"] = init_kv_cache(cfg, batch, cross_seq or seq, device)
    return c


def cross_kv(p_cross: dict, cfg: ModelConfig, memory: torch.Tensor) -> KVCache:
    """Project encoder memory to K/V once (cached for the whole decode).
    The keys take ``k_norm`` where the layer has one; no rope."""
    k = torch.einsum("bsd,dhk->bshk", memory, p_cross["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, p_cross["wv"])
    if "bk" in p_cross:
        k, v = k + p_cross["bk"], v + p_cross["bv"]
    if "k_norm" in p_cross:
        k = rms_norm(k, p_cross["k_norm"], cfg.norm_eps)
    return KVCache(k=k, v=v)


# -------------------------------------------------------------------- layer apply
def apply_layer(
    p: dict, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor, *,
    mode: str, positions=None, cache: dict | None = None, pos=None,
    causal: bool = True, cross_memory: torch.Tensor | None = None,
    mem_positions=None, capacities=None,
):
    """Returns (x, new_cache, aux): the cache is None in train mode; aux is
    the MoE layer's load-balancing loss, and the number 0.0 for other
    layers and in decode (adding it changes no sum, and it launches
    nothing)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode: {mode!r}")
    h = apply_norm(cfg, p["norm1"], x)
    new_cache: dict[str, Any] = {}
    if spec.mixer == "mamba":
        if mode == "decode":
            a, new_cache["self"] = mamba_decode(p["mamba"], cfg, h,
                                                cache["self"])
        else:
            a, c = mamba_train(p["mamba"], cfg, h)
            if mode == "prefill":
                new_cache["self"] = c
    elif spec.mixer == "mla":
        if mode == "train":
            a = mla_train(p["mla"], cfg, h, positions, causal=causal)
        elif mode == "prefill":
            a, new_cache["self"] = mla_prefill(p["mla"], cfg, h, positions)
        else:
            a, new_cache["self"] = mla_decode(p["mla"], cfg, h, cache["self"],
                                              pos)
    elif spec.mixer != "attn":
        raise ValueError(spec.mixer)
    elif mode == "train":
        a = attention_train(p["attn"], cfg, h, positions, causal=causal)
    elif mode == "prefill":
        a, new_cache["self"] = attention_prefill(p["attn"], cfg, h, positions)
    else:
        a, new_cache["self"] = attention_decode(p["attn"], cfg, h,
                                                cache["self"], pos)
    x = x + a

    if spec.cross_attn:
        h = apply_norm(cfg, p["norm_cross"], x)
        if mode == "train":
            a = attention_train(
                p["cross"], cfg, h, positions, causal=False,
                xkv=cross_memory, kv_positions=mem_positions, rope=False)
        elif mode == "prefill":
            ckv = cross_kv(p["cross"], cfg, cross_memory)
            new_cache["cross"] = ckv
            # As the reference: no cross_len, the whole memory is valid.
            a, _ = attention_decode(p["cross"], cfg, h, ckv, None, cross=True)
        else:
            # As the reference: no cross_len, so a cross cache longer than
            # the memory attends to its zero rows too.
            a, _ = attention_decode(p["cross"], cfg, h, cache["cross"], None,
                                    cross=True)
            new_cache["cross"] = cache["cross"]
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
    return x, (None if mode == "train" else new_cache), aux


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


def _init_stacked(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                  n_periods: int) -> dict:
    """``n_periods`` draws of one layer, stacked on a leading axis as
    ``_stack`` lays them out, each written into its slot as it is drawn:
    the peak holds the stack and one layer, where stacking a list of every
    period would hold the stack twice."""
    leaves, treedef = tree_flatten(init_layer(gen, cfg, spec))
    out = [torch.empty((n_periods,) + tuple(leaf.shape), dtype=leaf.dtype,
                       device=leaf.device) for leaf in leaves]
    for t in range(n_periods):
        if t:
            leaves = tree_flatten(init_layer(gen, cfg, spec))[0]
        for slot, leaf in zip(out, leaves, strict=True):
            slot[t] = leaf
        del leaves
    return tree_unflatten(treedef, out)


def _layout(cfg: ModelConfig, pattern, prefix, n_periods):
    """The stack's (pattern, prefix, n_periods): the config's unless
    given."""
    return (cfg.layer_pattern if pattern is None else pattern,
            cfg.prefix_pattern if prefix is None else prefix,
            cfg.n_periods if n_periods is None else n_periods)


def init_stack(gen: torch.Generator, cfg: ModelConfig, *, pattern=None,
               prefix=None, n_periods=None) -> dict:
    pattern, prefix, n_periods = _layout(cfg, pattern, prefix, n_periods)
    out: dict[str, Any] = {}
    if prefix:
        out["prefix"] = [init_layer(gen, cfg, s) for s in prefix]
    out["periods"] = {f"pos{i}": _init_stacked(gen, cfg, spec, n_periods)
                      for i, spec in enumerate(pattern)}
    return out


def init_stack_cache(cfg: ModelConfig, batch: int, seq: int, device, *,
                     pattern=None, prefix=None, n_periods=None,
                     cross_seq: int | None = None) -> dict:
    pattern, prefix, n_periods = _layout(cfg, pattern, prefix, n_periods)
    out: dict[str, Any] = {}
    if prefix:
        out["prefix"] = [init_layer_cache(cfg, s, batch, seq, device,
                                          cross_seq) for s in prefix]
    periods = {}
    for i, spec in enumerate(pattern):
        single = init_layer_cache(cfg, spec, batch, seq, device, cross_seq)
        periods[f"pos{i}"] = {key: type(c)(**{
            name: torch.zeros((n_periods,) + tuple(t.shape), dtype=t.dtype,
                              device=device)
            for name, t in _fields(c).items()}) for key, c in single.items()}
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
                       pattern, prefix, remat: bool, **kw):
    if remat and cfg.remat_policy == "dots":
        raise NotImplementedError(_LATER["dots"])
    aux = 0.0
    for i, spec in enumerate(prefix):
        x, _, a = apply_layer(params["prefix"][i], cfg, spec, x, mode="train",
                              **kw)
        aux = aux + a

    def body(h: torch.Tensor, aux_acc, per_params: dict):
        # The aux sum enters and leaves the checkpointed body as an argument
        # and an output, as the scan carry does in the reference: its
        # gradient survives the checkpoint, and the sum runs in the
        # reference's layer order.  The cross memory comes in by closure;
        # the non-reentrant checkpoint carries its gradient.
        for i, spec in enumerate(pattern):
            h, _, a = apply_layer(per_params[f"pos{i}"], cfg, spec, h,
                                  mode="train", **kw)
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
    causal: bool = True, cross_memory=None, mem_positions=None,
    capacities=None, pattern=None, prefix=None, remat: bool = True,
):
    """Returns (x, new_caches, aux): the caches are None in train mode; aux
    is the sum of the MoE layers' load-balancing losses in layer order (the
    number 0.0 without any).  In decode mode the caches are updated in
    place (see ``attention._cache_write``) and returned.  ``causal`` is the
    mixers' mask in train mode (False in an encoder); ``cross_memory`` and
    ``mem_positions`` feed the cross-attention of enc-dec decoder layers;
    ``capacities`` are the MoE layers' per-expert capacities (train and
    prefill; None: uniform); ``pattern`` and ``prefix`` the stack's layers
    (the config's by default).  ``remat`` (train mode) recomputes each
    period's forward in the backward instead of keeping its activations."""
    pattern, prefix, _ = _layout(cfg, pattern, prefix, 0)
    kw = dict(positions=positions, causal=causal, cross_memory=cross_memory,
              mem_positions=mem_positions, capacities=capacities)
    if mode == "train":
        x, aux = _apply_stack_train(params, cfg, x, pattern, prefix, remat,
                                    **kw)
        return x, None, aux
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode: {mode!r}")
    aux = 0.0
    new_prefix = []
    for i, spec in enumerate(prefix):
        c = caches["prefix"][i] if caches is not None else None
        x, nc, a = apply_layer(params["prefix"][i], cfg, spec, x, mode=mode,
                               cache=c, pos=pos, **kw)
        aux = aux + a
        new_prefix.append(nc)
    per_period = []
    n_periods = tree_flatten(params["periods"])[0][0].shape[0]
    for t in range(n_periods):
        ncs = {}
        for i, spec in enumerate(pattern):
            key = f"pos{i}"
            c = (_index(caches["periods"][key], t)
                 if mode == "decode" else None)
            x, ncs[key], a = apply_layer(
                _index(params["periods"][key], t), cfg, spec, x, mode=mode,
                cache=c, pos=pos, **kw)
            aux = aux + a
        per_period.append(ncs)
    if mode == "decode":
        out_caches = caches
    else:
        out_caches = {"periods": _stack(per_period)}
        if prefix:
            out_caches["prefix"] = new_prefix
    return x, out_caches, aux
