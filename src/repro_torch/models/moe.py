"""Mixture-of-Experts with homogenized expert capacity.

Port of ``repro/models/moe.py``.  Routing is top-k with capacity buckets
built by a sort-free rank scatter (static shapes): each token gets a rank
among the tokens routed to its expert via a cumulative one-hot count; tokens
whose rank exceeds the expert's capacity are dropped (GShard/Switch
semantics).

**Homogenization hook (the paper's technique at expert granularity):** each
expert's capacity is its *scope length*.  ``capacity_per_expert`` takes a
performance vector (measured expert throughput, or a proxy such as
historical load) and allots the global token budget proportionally through
``core.homogenization.scope_lengths``, so all experts finish their expert
MLPs at the same time.  Uniform perfs degrade to the classic equal capacity.

Shared experts run densely beside the routed path.

What the port keeps of the reference, value for value:

  - top-k takes ties lowest expert index first, as ``jax.lax.top_k`` does:
    a stable descending sort (``torch.topk`` promises no order for ties);
  - the router is f32 whatever ``param_dtype`` is (``F32_LEAVES``), and its
    logits come from the tokens widened to f32;
  - a dropped assignment goes to the sentinel bucket ``E * cap_max``, which
    the reference's ``mode="drop"`` scatter discards and its gather clamps
    before ``keep`` masks it: the scatter here writes the sentinel into one
    spare slot that is cut off, and the gather clamps the index;
  - ``cap`` and ``cap_max`` come from the token count on the host, pad
    tokens of a bucketed prefill included (ranks follow token order, so
    pads rank after the real tokens);
  - the expert MLP rounds as ``silu(g.float()).to(x.dtype) * u``, and the
    combine multiplies by the gates in ``x.dtype`` and sums over k there.

Split over ranks (``group``, a ``models/parallel.py::Group`` of more than
one rank), as ``sharding/policy.py`` stores the experts: expert-parallel
where ``w_gate`` holds E/m of the experts (this rank's, in order), expert-
TP where it holds every expert at ff/m of its width.  Every rank routes the
whole token set alike (the router is replicated), so ranks and ``keep``
are the unsplit layer's; it runs its experts' buckets only (expert-
parallel) or every bucket at its width (expert-TP), and returns its
partial combine in f32, the shared expert's column/row-parallel partial
added, for the caller's one all-reduce.  No token moves between ranks.

Plain tensor code, no kernel: the reference's MoE has no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.homogenization import scope_lengths
from .config import ModelConfig
from .layers import dense_init, dtype_of
from .parallel import SOLO, Group

__all__ = ["F32_LEAVES", "capacity_per_expert", "init_moe", "apply_moe",
           "apply_moe_dense", "expert_load"]

#: Leaves kept in f32 whatever ``param_dtype`` is (the bridge leaves them
#: uncast).
F32_LEAVES = ("router",)


def capacity_per_expert(
    n_tokens: int, cfg_moe, expert_perfs=None, round_to: int = 8
) -> np.ndarray:
    """Scope-length allotment of the routed-token budget across experts."""
    e = cfg_moe.n_routed
    budget = int(cfg_moe.capacity_factor * n_tokens * cfg_moe.top_k)
    if expert_perfs is None:
        caps = np.full(e, (budget + e - 1) // e, np.int64)
    else:
        caps = np.asarray(scope_lengths(budget, list(expert_perfs)), np.int64)
    caps = np.maximum((caps + round_to - 1) // round_to * round_to, round_to)
    return caps


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    m = cfg.moe
    dt = dtype_of(cfg.param_dtype)
    p = {
        "router": dense_init(gen, (cfg.d_model, m.n_routed), torch.float32,
                             scale=0.1),
        "w_gate": dense_init(gen, (m.n_routed, cfg.d_model, m.d_expert), dt),
        "w_up": dense_init(gen, (m.n_routed, cfg.d_model, m.d_expert), dt),
        "w_down": dense_init(gen, (m.n_routed, m.d_expert, cfg.d_model), dt),
    }
    if m.n_shared:
        p["shared"] = {
            "w_gate": dense_init(gen, (cfg.d_model, m.d_shared), dt),
            "w_up": dense_init(gen, (cfg.d_model, m.d_shared), dt),
            "w_down": dense_init(gen, (m.d_shared, cfg.d_model), dt),
        }
    return p


def _route(p: dict, m, xt: torch.Tensor):
    """Router probabilities (T, E) and the top-k gates and experts (T, K).
    Ties go to the lower expert index, as ``jax.lax.top_k`` gives them."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, experts = vals[:, :m.top_k], idx[:, :m.top_k]
    if m.normalize_topk:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals * m.routed_scaling, experts


def _expert_mlp(x: torch.Tensor, w_gate, w_up, w_down,
                group: Group | None = None) -> torch.Tensor:
    """SwiGLU experts; ``group`` forms ``w_down``'s row-parallel product
    where the width is split (the expert-TP experts, the shared expert)."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    if group is None:
        return h @ w_down
    return group.row_product(torch.matmul, h, w_down)


def _shared(p: dict, m, x: torch.Tensor, out: torch.Tensor,
            group: Group = SOLO) -> torch.Tensor:
    if not m.n_shared:
        return out
    sp = p["shared"]
    # Split over ranks, its width is split too (``sharding/apply.py``
    # splits the layer only then): a row-parallel partial.
    return out + _expert_mlp(x, sp["w_gate"], sp["w_up"], sp["w_down"],
                             None if group.size == 1 else group)


def _experts(p: dict, m, group: Group) -> tuple[int, int, Group | None]:
    """This rank's experts ``[lo, lo + n)`` and the group of ``w_down``'s
    row-parallel product (expert-TP), or None (whole experts)."""
    n = p["w_gate"].shape[0]
    if n < m.n_routed:                     # expert-parallel
        return group.rank * n, n, None
    if p["w_gate"].shape[2] < m.d_expert:  # expert-TP
        return 0, n, group
    return 0, n, None


def apply_moe(
    p: dict, cfg: ModelConfig, x: torch.Tensor, capacities=None, *,
    group: Group = SOLO,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  ``capacities``: (E,) ints (a
    tensor, array or list); None => uniform capacity from the config's
    capacity factor.  Under ``group`` of more than one rank ``out`` is
    this rank's partial sum in f32."""
    m = cfg.moe
    e, k = m.n_routed, m.top_k
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)
    probs, gate_vals, experts = _route(p, m, xt)

    # Load-balancing aux loss (Switch): E * sum_e f_e * p_e.
    me = probs.mean(dim=0)
    fe = F.one_hot(experts[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(fe * me) * m.router_aux_coef

    if capacities is None:
        cap = int(np.ceil(m.capacity_factor * t * k / e))
        cap = max((cap + 7) // 8 * 8, 8)
        capacities = torch.full((e,), cap, dtype=torch.int64, device=dev)
    elif isinstance(capacities, torch.Tensor):
        capacities = capacities.to(dev)
    else:
        capacities = torch.as_tensor(np.asarray(capacities), device=dev)
    cap_max = int(np.ceil(m.capacity_factor * t * k / e * 2))
    cap_max = max((cap_max + 7) // 8 * 8, 8)

    # Rank of each (token, k) assignment within its expert (order: token id).
    flat_experts = experts.reshape(-1)                            # (T*K,)
    eo = F.one_hot(flat_experts, e)
    ranks = torch.cumsum(eo, dim=0) - eo
    rank_in_expert = ranks.gather(1, flat_experts[:, None]).reshape(t, k)
    keep = (rank_in_expert < capacities[experts]) & (rank_in_expert < cap_max)

    # Scatter this rank's tokens into its (E, C) buckets (every expert on
    # one rank).  Dropped assignments, and under expert parallelism those
    # of other ranks' experts, point at the sentinel E * cap_max: the one
    # spare slot, cut off after the scatter.
    lo, n_e, down = _experts(p, m, group)
    if n_e < m.n_routed:
        keep = keep & (experts >= lo) & (experts < lo + n_e)
    sentinel = n_e * cap_max
    bucket_idx = torch.where(keep, (experts - lo) * cap_max + rank_in_expert,
                             sentinel)                            # (T, K)
    flat_idx = bucket_idx.reshape(-1)
    token_ids = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    gather_src = torch.zeros(sentinel + 1, dtype=torch.int64, device=dev)
    gather_src.scatter_(0, flat_idx, token_ids)
    filled = torch.zeros(sentinel + 1, dtype=torch.bool, device=dev)
    filled.scatter_(0, flat_idx, True)
    gather_src, filled = gather_src[:sentinel], filled[:sentinel]

    xg = xt[gather_src.reshape(n_e, cap_max)]                     # (E, C, d)
    xg = torch.where(filled.reshape(n_e, cap_max, 1), xg, 0)
    yo = _expert_mlp(xg, p["w_gate"], p["w_up"], p["w_down"],
                     down)                                        # (E, C, d)

    # Combine: token t gets sum_k gate * y[expert_k, slot_k].  The sentinel
    # reads the last row (the reference's gather clamps it); keep masks it.
    # Split over ranks: each rank's partial in f32, rounded once after the
    # ranks' sum.
    per_k = yo.reshape(sentinel, d)[bucket_idx.clamp(max=sentinel - 1)]
    if group.size == 1:
        gates = gate_vals[..., None].to(x.dtype)
    else:
        per_k, gates = per_k.float(), gate_vals[..., None]
    combine = torch.where(keep[..., None], per_k * gates, 0)
    out = combine.sum(dim=1).reshape(b, s, d)
    return _shared(p, m, x, out, group), aux


def apply_moe_dense(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                    group: Group = SOLO
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dropless decode path: sweep every expert over the (small) token batch
    and mask by the top-k gates.  Exact (no capacity drops); FLOPs are
    E/top_k times the routed cost, the right trade at decode batch sizes
    (T = B·1) where the capacity machinery would be all overhead.  Under
    ``group`` of more than one rank each rank sweeps its own experts (or
    every expert at its width) and ``out`` is its partial sum in f32."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    _, gate_vals, experts = _route(p, m, xt)
    gates = torch.zeros((t, m.n_routed), dtype=torch.float32,
                        device=x.device).scatter_add_(1, experts, gate_vals)
    lo, n_e, down = _experts(p, m, group)
    y = _expert_mlp(xt, p["w_gate"], p["w_up"], p["w_down"],
                    down)                                        # (E, T, d)
    if group.size == 1:
        out = torch.einsum("etd,te->td", y, gates.to(x.dtype))
    else:
        out = torch.einsum("etd,te->td", y.float(), gates[:, lo:lo + n_e])
    return _shared(p, m, x, out.reshape(b, s, d), group), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def expert_load(cfg_moe, probs_or_logits: torch.Tensor) -> torch.Tensor:
    """Diagnostic: fraction of top-1 routed tokens per expert."""
    probs = torch.softmax(probs_or_logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    return torch.bincount(top1, minlength=cfg_moe.n_routed) / probs.shape[0]
