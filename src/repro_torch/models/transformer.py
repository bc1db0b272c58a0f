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
summed in the reference's layer order.

``remat_policy="dots"`` keeps, of each checkpointed period, the outputs of
the matrix products without batch dimensions (``aten.mm``, ``aten.addmm``)
and recomputes the rest, as ``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable`` does: batched products (``bmm``: the
plain attention's and the experts' einsums) and K4's autograd function are
recomputed.

Every apply takes ``par`` (``models/parallel.py``), the one object between
the model and sharding: the stack takes its periods (and a decode its cache
periods) from it, each layer its groups (attention, MLA, cross-attention
and Mamba heads, dense-MLP width, MoE experts or their width split over
ranks, or the layer computed whole where they do not divide), and an MoE
layer its token set and its share of the experts' slots.  ``SINGLE``, the
default, is the identity on every hook.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..tree import tree_flatten, tree_unflatten
from .attention import (  # noqa: F401 (cross_kv: the layer's cross cache)
    attention_decode,
    attention_prefill,
    attention_train,
    cross_kv,
    cross_prefill,
    init_attention,
    init_kv_cache,
)
from .config import LayerSpec, ModelConfig
from .layers import apply_mlp, apply_norm, init_mlp, init_norm
from .mamba import init_mamba, init_mamba_cache, mamba_decode, mamba_train
from .mla import init_mla, init_mla_cache, mla_decode, mla_prefill, mla_train
from .moe import apply_moe, apply_moe_dense, init_moe
from .parallel import SINGLE, Parallel, fields

#: The products ``remat_policy="dots"`` saves: matrix products without
#: batch dimensions.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


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


# -------------------------------------------------------------------- layer apply
def apply_layer(
    p: dict, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor, *,
    mode: str, positions=None, cache: dict | None = None, pos=None,
    causal: bool = True, cross_memory: torch.Tensor | None = None,
    mem_positions=None, capacities=None, par: Parallel = SINGLE,
):
    """Returns (x, new_cache, aux): the cache is None in train mode; aux is
    the MoE layer's load-balancing loss, and the number 0.0 for other
    layers and in decode (adding it changes no sum, and it launches
    nothing).  Each mixer and MLP runs in its group of ``par``: attention
    on this rank's heads and the dense MLP on its columns where ``par``
    split them, every other layer whole; an MoE layer routes
    ``par.moe_tokens`` (a sharded step's global token set, as the
    reference's compiled step routes it), computes its data rank's share
    of the experts' capacity slots (``par.moe_share``) and the shared
    expert on its own rows, and takes its rows of the data ranks' summed
    partials (``par.moe_rows``).
    Mamba splits its heads; an MoE layer its experts (expert-parallel) or
    their width (expert-TP), its aux loss's gradient counted once over the
    group (``Group.once``).  MLA and cross-attention split their heads
    (the encoder memory entering through ``Group.kv_in``, its gradient
    summed over the ranks)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode: {mode!r}")
    new_cache: dict[str, Any] = {}
    if spec.mixer == "attn":
        g = par.split(p["attn"]["wq"].shape[1], cfg.n_q_heads)
    elif spec.mixer == "mamba":
        g = par.split(p["mamba"]["wdt"].shape[1],
                      cfg.ssm.n_heads(cfg.d_model))
    elif spec.mixer == "mla":
        g = par.split(p["mla"]["wuq"].shape[1], cfg.n_q_heads)
    else:
        raise ValueError(spec.mixer)
    h = g.col_in(apply_norm(cfg, p["norm1"], x))
    if spec.mixer == "mamba":
        if mode == "decode":
            a, new_cache["self"] = mamba_decode(p["mamba"], cfg, h,
                                                cache["self"], group=g)
        else:
            a, c = mamba_train(p["mamba"], cfg, h, group=g,
                               cache=mode == "prefill")
            if mode == "prefill":
                new_cache["self"] = c
    elif spec.mixer == "mla":
        if mode == "train":
            a = mla_train(p["mla"], cfg, h, positions, causal=causal, group=g)
        elif mode == "prefill":
            a, new_cache["self"] = mla_prefill(p["mla"], cfg, h, positions,
                                               group=g)
        else:
            a, new_cache["self"] = mla_decode(p["mla"], cfg, h, cache["self"],
                                              pos, group=g)
    elif mode == "train":
        a = attention_train(p["attn"], cfg, h, positions, causal=causal,
                            group=g)
    elif mode == "prefill":
        a, new_cache["self"] = attention_prefill(p["attn"], cfg, h,
                                                 positions, group=g)
    else:
        a, new_cache["self"] = attention_decode(p["attn"], cfg, h,
                                                cache["self"], pos, group=g)
    x = x + g.row_out(a).to(x.dtype)

    if spec.cross_attn:
        g = par.split(p["cross"]["wq"].shape[1], cfg.n_q_heads)
        h = g.col_in(apply_norm(cfg, p["norm_cross"], x))
        if mode == "train":
            a = attention_train(
                p["cross"], cfg, h, positions, causal=False,
                xkv=g.kv_in(cross_memory), kv_positions=mem_positions,
                rope=False, group=g)
        elif mode == "prefill":
            # As the reference: no cross_len, the whole memory is valid.
            a, new_cache["cross"] = cross_prefill(p["cross"], cfg, h,
                                                  cross_memory, group=g)
        else:
            # As the reference: no cross_len, so a cross cache longer than
            # the memory attends to its zero rows too.
            a, _ = attention_decode(p["cross"], cfg, h, cache["cross"], None,
                                    cross=True, group=g)
            new_cache["cross"] = cache["cross"]
        x = x + g.row_out(a).to(x.dtype)

    aux = 0.0
    if spec.mlp == "dense":
        g = par.split(p["mlp"]["w_down"].shape[0], cfg.d_ff)
        h = g.col_in(apply_norm(cfg, p["norm2"], x))
        x = x + g.row_out(apply_mlp(p["mlp"], h, g)).to(x.dtype)
    elif spec.mlp == "moe":
        m, w = cfg.moe, p["moe"]["w_gate"]
        g = (par.split(w.shape[0], m.n_routed) if w.shape[0] != m.n_routed
             else par.split(w.shape[2], m.d_expert))
        h = g.col_in(apply_norm(cfg, p["norm2"], x))
        if mode == "decode":
            mo, _ = apply_moe_dense(p["moe"], cfg, h, group=g)
        else:
            mo, aux = apply_moe(p["moe"], cfg, h, capacities, group=g,
                                par=par)
            aux = g.once(aux)
        x = x + g.row_out(mo).to(x.dtype)
    return x, (None if mode == "train" else new_cache), aux


# -------------------------------------------------------------------- stack
def _stack(items: list) -> Any:
    """Stack per-period pytrees (dicts / cache dataclasses of tensors) on a
    new leading axis — the layout ``lax.scan`` gives the reference."""
    treedef = tree_flatten(items[0])[1]
    cols = [tree_flatten(it)[0] for it in items]
    return tree_unflatten(treedef, [torch.stack(leaves)
                                    for leaves in zip(*cols, strict=True)])


def _no_periods(cfg: ModelConfig, pattern, x: torch.Tensor,
                cross_memory) -> dict:
    """The prefill caches of a stack with no periods: each layer's cache
    leaves with a period axis of 0, as the reference's ``lax.scan`` over
    zero periods returns them (the shapes of ``init_cache``'s leaves)."""
    b, s = x.shape[:2]
    cross = None if cross_memory is None else cross_memory.shape[1]
    out = {}
    for i, spec in enumerate(pattern):
        single = init_layer_cache(cfg, spec, b, s, "meta", cross)
        out[f"pos{i}"] = {key: type(c)(**{
            name: torch.zeros((0,) + tuple(t.shape), dtype=t.dtype,
                              device=x.device)
            for name, t in fields(c).items()}) for key, c in single.items()}
    return out


def _init_stacked(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                  n_periods: int) -> dict:
    """``n_periods`` draws of one layer, stacked on a leading axis as
    ``_stack`` lays them out, each written into its slot as it is drawn:
    the peak holds the stack and one layer, where stacking a list of every
    period would hold the stack twice.  Zero periods draw nothing (the
    layer's shapes come from fake tensors), as the reference's init over
    no period keys."""
    if n_periods == 0:
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            leaves, treedef = tree_flatten(init_layer(
                torch.Generator(), cfg, spec))
        return tree_unflatten(treedef, [
            torch.empty((0,) + tuple(leaf.shape), dtype=leaf.dtype,
                        device=gen.device) for leaf in leaves])
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
            for name, t in fields(c).items()}) for key, c in single.items()}
    out["periods"] = periods
    return out


def _apply_stack_train(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       pattern, prefix, remat: bool, par: Parallel, **kw):
    per_list, gather = par.periods(params["periods"])
    aux = 0.0
    for i, spec in enumerate(prefix):
        x, _, a = apply_layer(params["prefix"][i], cfg, spec, x, mode="train",
                              par=par, **kw)
        aux = aux + a
    # Between the periods the residual stream may be split over ranks
    # (``seq_parallel``): each period's checkpoint then keeps a share of
    # its input, and its layers take ``inner``'s groups.
    x = par.seq_split(x)
    inner = par.in_periods()

    def body(h: torch.Tensor, aux_acc, per_params: dict):
        # The aux sum enters and leaves the checkpointed body as an argument
        # and an output, as the scan carry does in the reference: its
        # gradient survives the checkpoint, and the sum runs in the
        # reference's layer order.  The cross memory comes in by closure;
        # the non-reentrant checkpoint carries its gradient.  A sharded
        # period is gathered here, so the checkpoint keeps only its shards.
        per_params = gather(per_params)
        for i, spec in enumerate(pattern):
            h, _, a = apply_layer(per_params[f"pos{i}"], cfg, spec, h,
                                  mode="train", par=inner, **kw)
            aux_acc = aux_acc + a
        return h, aux_acc

    extra = {"context_fn": _dots_context} if cfg.remat_policy == "dots" \
        else {}
    for per_params in per_list:
        if remat:
            # The reference's jax.checkpoint of the scan body: only the
            # period's input is kept ("dots": and its matrix products'
            # outputs); its forward runs again in the backward.
            x, aux = checkpoint(body, x, aux, per_params, use_reentrant=False,
                                preserve_rng_state=False, **extra)
        else:
            x, aux = body(x, aux, per_params)
    return par.seq_gather(x), aux


def apply_stack(
    params: dict, cfg: ModelConfig, x: torch.Tensor, *,
    mode: str, positions=None, caches: dict | None = None, pos=None,
    causal: bool = True, cross_memory=None, mem_positions=None,
    capacities=None, pattern=None, prefix=None, remat: bool = True,
    par: Parallel = SINGLE,
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
    period's forward in the backward instead of keeping its activations.
    ``par`` gives the periods, the cache periods and each layer's groups
    (``models/parallel.py``)."""
    pattern, prefix, _ = _layout(cfg, pattern, prefix, 0)
    kw = dict(positions=positions, causal=causal, cross_memory=cross_memory,
              mem_positions=mem_positions, capacities=capacities)
    if mode == "train":
        x, aux = _apply_stack_train(params, cfg, x, pattern, prefix, remat,
                                    par, **kw)
        return x, None, aux
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode: {mode!r}")
    aux = 0.0
    new_prefix = []
    for i, spec in enumerate(prefix):
        c = caches["prefix"][i] if caches is not None else None
        x, nc, a = apply_layer(params["prefix"][i], cfg, spec, x, mode=mode,
                               cache=c, pos=pos, par=par, **kw)
        aux = aux + a
        new_prefix.append(nc)
    per_period = []
    per_list, gather = par.periods(params["periods"])
    cache_periods = (par.cache_periods(caches["periods"]) if mode == "decode"
                     else None)
    for t, per_params in enumerate(per_list):
        per_params = gather(per_params)
        per_cache = cache_periods.period(t) if mode == "decode" else None
        ncs = {}
        for i, spec in enumerate(pattern):
            key = f"pos{i}"
            c = per_cache[key] if mode == "decode" else None
            x, ncs[key], a = apply_layer(
                per_params[key], cfg, spec, x, mode=mode, cache=c, pos=pos,
                par=par, **kw)
            aux = aux + a
        if mode == "decode":
            cache_periods.commit(t, ncs)
        per_period.append(ncs)
    if mode == "decode":
        out_caches = caches
    else:
        out_caches = {"periods": _stack(per_period) if per_period else
                      _no_periods(cfg, pattern, x, cross_memory)}
        if prefix:
            out_caches["prefix"] = new_prefix
    return x, out_caches, aux
