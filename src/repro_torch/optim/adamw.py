"""AdamW with cosine schedule and global-norm clipping.

Port of ``repro/optim/adamw.py``.  Moments are f32 regardless of the param
dtype (bf16 params update through an f32 delta); weight decay is decoupled
and applies to leaves with ``ndim >= 2`` only (stacked period leaves count
their period axis, as in the reference).  The state is a plain pytree
``{"m", "step", "v"}`` whose leaves follow the params' leaf order
(``repro_torch.tree``), so checkpoints cross-load with the reference's.

``adamw_update`` writes the new moments into the given ``m`` and ``v``
tensors, as the reference's jitted update reuses the donated optimizer
state's buffers: at full width two copies of the f32 moments would not fit
beside the gradients.  Each in-place step rounds exactly as the reference's
expression does.  Params come back as new tensors, unless ``in_place``:
then the new params are written into the given ones, and the new step into
``opt_state["step"]`` (each ``copy_`` of the same expression, so the same
bits), which is how the compiled training steps (``train/step.py``) keep
the addresses their graphs read.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "lr_at", "init_opt_state", "global_norm",
           "adamw_update"]

#: A leaf larger than this many elements is updated this many at a time
#: (a slice of its flat view), so the update's f32 temporaries stay near
#: this size and not the leaf's: at full width one stacked MLP leaf's are
#: several GB, and beside the moments they decided which depths fit the
#: card.  The update is elementwise, so each element rounds as before.
SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), in f32."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0, 1)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_flatten(params)[0][0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _sum_squares(t: torch.Tensor) -> torch.Tensor:
    """The f32 sum of the squares of ``t``'s elements: a ``SLICE`` of its
    flat view at a time, widened (or, in f32, squared) into one temporary,
    the slices' sums added in order.  A whole-leaf copy in f32 was several
    GB for a stacked leaf at full width."""
    flat = t.reshape(-1)
    total = None
    for lo in range(0, max(flat.numel(), 1), SLICE):
        part = flat[lo:lo + SLICE]
        s = torch.sum(torch.square(part) if part.dtype == torch.float32
                      else part.to(torch.float32).square_())
        total = s if total is None else total + s
    return total


def _local(leaf):
    """(the part of ``leaf`` this rank counts, its mesh): a plain tensor
    whole; of a DTensor its local shard, or nothing on a rank that is not
    the first of a mesh dimension the leaf is replicated over (each
    element is counted once over the mesh).  A ``Partial`` leaf raises:
    the square of a partial sum is not a part of the square of the sum."""
    if type(leaf) is torch.Tensor:
        return leaf, None
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        return leaf, None
    if any(p.is_partial() for p in leaf.placements):
        raise ValueError(f"global_norm: a Partial leaf ({leaf.placements}); "
                         f"redistribute it to Shard or Replicate first")
    mesh = leaf.device_mesh
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    mine = all(c == 0 for c, p in zip(coord, leaf.placements, strict=True)
               if p.is_replicate())
    return (leaf.to_local() if mine else None), mesh


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed in leaf order, each
    leaf a slice at a time (``_sum_squares``).  A tree of DTensors (the
    sharded step) sums each rank's shards the same way, reduces the total
    over the mesh and returns it replicated: at world size 1 the bits of
    the same tree unsharded."""
    total, mesh = 0, None
    for leaf in tree_flatten(tree)[0]:
        local, on = _local(leaf)
        if on is not None:
            if mesh is not None and on != mesh:
                raise ValueError("global_norm: the leaves lie on more than "
                                 "one mesh")
            mesh = on
        if local is not None:
            total = total + _sum_squares(local)
    if mesh is None:
        return torch.sqrt(total)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(total, torch.Tensor):
        total = torch.zeros((), dtype=torch.float32,
                            device=mesh.device_type)
    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
    return torch.sqrt(total.redistribute(mesh, [Replicate()] * mesh.ndim))


def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig, *,
                 in_place: bool = False):
    """Returns (new_params, new_opt_state, stats); with ``in_place``, the
    given ``params`` and ``opt_state``, updated."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    step_f = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** step_f
    b2c = 1 - cfg.b2 ** step_f

    def part(g, m, v, p, decay: bool):
        # m <- b1 m + (1 - b1) g and v <- b2 v + (1 - b2) g g, in place.
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype)

    def upd(g, m, v, p):
        # Decay matrices only (norms/bias exempt), standard.
        decay = p.ndim >= 2
        leaves = (g, m, v, p)
        if p.numel() <= SLICE or not all(
                type(t) is torch.Tensor and t.is_contiguous() for t in leaves):
            new = part(g, m, v, p, decay)
            return p.copy_(new) if in_place else new
        out = p if in_place else torch.empty_like(p)
        flat = [t.view(-1) for t in leaves + (out,)]
        for lo in range(0, p.numel(), SLICE):
            gs, ms, vs, ps, os_ = (t[lo:lo + SLICE] for t in flat)
            os_.copy_(part(gs, ms, vs, ps, decay))
        return out

    flat_p, treedef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(opt_state["m"])[0]
    flat_v = tree_flatten(opt_state["v"])[0]
    new_params = tree_unflatten(treedef, [
        upd(g, m, v, p)
        for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p, strict=True)])
    stats = {"grad_norm": gnorm, "lr": lr}
    if in_place:
        opt_state["step"].copy_(step)
        return params, opt_state, stats
    return new_params, {"m": opt_state["m"], "v": opt_state["v"],
                        "step": step}, stats
