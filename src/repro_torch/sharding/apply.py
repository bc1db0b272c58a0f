"""Sharded train, prefill and decode steps on DTensor.

The counterpart of the reference's ``jax.jit(step, in_shardings=...,
out_shardings=...)`` (``repro/launch/dryrun.py::build_step``), built on
``torch.distributed.tensor``:

  - **Storage.** ``distribute_tree`` stores params, both AdamW moments and
    the decode caches as DTensors at the policy's placements
    (``sharding/policy.py``): each rank holds its share of the bytes.
  - **Per-period gathers.** A step takes the model's periods one at a time
    and gathers each period's parameters to full local tensors
    (``redistribute(...).to_local(grad_placements=...)``), inside the
    period's checkpoint in training; the embedding, the norms and the
    prefix layers are gathered once a step.  So the model code, the
    checkpointed periods and the kernels see plain tensors.  A decode
    gathers each period's caches over ``model`` (the sequence) and writes
    its shard of them back.
  - **Backward.** A gathered parameter's gradient is a partial sum over the
    data ranks (each rank computed its own rows) and the same on every
    ``model`` rank, so it returns as a reduce-scatter (or all-reduce) over
    the data axes to the stored placements, and AdamW updates the shards.
    The global-norm clip takes the norm of the whole gradient (DTensor
    reductions).
  - **Batch.** The batch is split over the data axes (``batch_specs``).
    The loss divides by the global weight sum, and an MoE layer gathers
    its input over the data axes, routes the global token set (capacities
    and ranks as the reference's compiled step sees them) and keeps this
    rank's rows (``DataSplit``).

This is the fsdp/ZeRO layout of ``fsdp_tp`` (and ``tp``: weights
replicated over data) with data-parallel compute.  Tensor-parallel compute
and ``seq_parallel``'s residual-stream constraint are what GSPMD adds
inside the reference's compiled step; they are not ported, so every rank
of a ``model`` group computes the same rows.

With ``n_micro > 1`` the training step splits this rank's rows into
microbatches (the reference splits the global batch): without MoE the
accumulated gradient is the same sum, with MoE the aux terms follow the
other partition.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

from ..models.model import Model
from ..optim.adamw import AdamWConfig, adamw_update
from ..tree import tree_flatten, tree_map, tree_paths, tree_unflatten
from ..train.train_state import TrainState
from .policy import is_spec, to_placements

__all__ = ["DataSplit", "distribute_tree", "local_tree", "full_tree",
           "make_sharded_train_step", "make_sharded_prefill_step",
           "make_sharded_decode_step"]


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of ``tree`` as a DTensor at its spec's placements.  Each
    rank passes the same full tensors and keeps its own shard of each (no
    communication); at world size 1 the DTensors may share storage with
    the given tensors."""
    leaves, treedef = tree_flatten(tree)
    spec_leaves = tree_flatten(specs, is_leaf=is_spec)[0]
    return tree_unflatten(treedef, [
        distribute_tensor(leaf, mesh, to_placements(spec, mesh),
                          src_data_rank=None)
        for leaf, spec in zip(leaves, spec_leaves, strict=True)])


def local_tree(tree: Any) -> Any:
    """Each DTensor leaf's local shard."""
    return tree_map(lambda d: d.to_local() if isinstance(d, DTensor) else d,
                    tree)


def full_tree(tree: Any) -> Any:
    """Each DTensor leaf gathered to its full tensor (a collective)."""
    return tree_map(lambda d: d.full_tensor() if isinstance(d, DTensor)
                    else d, tree)


def _all_replicate(mesh) -> list:
    return [Replicate() for _ in range(mesh.ndim)]


def _shift(placements) -> list:
    """The placements of one period of a stacked leaf (period axis 0
    dropped; it is never sharded)."""
    return [Shard(p.dim - 1) if isinstance(p, Shard) else p
            for p in placements]


class DataSplit:
    """A batch's rows split over the mesh dimensions ``dims`` (the data
    axes that ``batch_specs`` shards its first dimension over; none when
    the batch does not divide).  The model code (``models/model.py::loss``,
    ``transformer.apply_layer``) reads it."""

    def __init__(self, mesh, dims: tuple[int, ...]):
        self.mesh = mesh
        self.dims = dims
        self.n = math.prod(mesh.size(d) for d in dims)
        coord = mesh.get_coordinate() or [0] * mesh.ndim
        index = 0
        for d in dims:                       # major mesh dimension first
            index = index * mesh.size(d) + coord[d]
        self.index = index
        self.grad_placements = [Partial() if i in dims else Replicate()
                                for i in range(mesh.ndim)]

    @staticmethod
    def of(tree: Any, mesh) -> "DataSplit":
        """The split of the first leaf of a tree of DTensors that has a
        dimension."""
        for leaf in tree_flatten(tree)[0]:
            if isinstance(leaf, DTensor) and leaf.ndim:
                return DataSplit(mesh, tuple(
                    i for i, p in enumerate(leaf.placements)
                    if isinstance(p, Shard) and p.dim == 0))
        return DataSplit(mesh, ())

    def rows(self, dim: int = 0) -> list:
        """Placements of a tensor whose dimension ``dim`` holds this rank's
        rows."""
        return [Shard(dim) if i in self.dims else Replicate()
                for i in range(self.mesh.ndim)]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data ranks (an all-reduce)."""
        placements = [Partial() if i in self.dims else Replicate()
                      for i in range(self.mesh.ndim)]
        return DTensor.from_local(t, self.mesh, placements,
                                  run_check=False).full_tensor()

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's rows of ``x`` (an all-gather over the data
        ranks); its gradient returns as a reduce-scatter."""
        return DTensor.from_local(x, self.mesh, self.rows(), run_check=False
                                  ).redistribute(
            self.mesh, _all_replicate(self.mesh)).to_local(
            grad_placements=self.grad_placements)

    def own_rows(self, y: torch.Tensor) -> torch.Tensor:
        rows = y.shape[0] // self.n
        return y.narrow(0, self.index * rows, rows)

    def as_dtensor(self, t: torch.Tensor, dim: int = 0) -> DTensor:
        return DTensor.from_local(t, self.mesh, self.rows(dim),
                                  run_check=False)


def _gather(local: torch.Tensor, placements, mesh, grad_placements
            ) -> torch.Tensor:
    """A shard's full tensor; the gradient returns to the shard."""
    return DTensor.from_local(local, mesh, placements, run_check=False
                              ).redistribute(mesh, _all_replicate(mesh)
                                             ).to_local(
        grad_placements=grad_placements)


class ShardedPeriods:
    """A stack's stored periods for ``transformer.apply_stack``: ``unbind``
    gives each period's shards (views of ``local``, whose gradients stack
    in one op), ``gather`` a period's full tensors."""

    def __init__(self, stored: Any, local: Any, mesh, grad_placements):
        leaves, self._treedef = tree_flatten(local)
        self._leaves = leaves
        self._placements = [_shift(d.placements)
                            for d in tree_flatten(stored)[0]]
        self._mesh = mesh
        self._grad = grad_placements

    def unbind(self) -> list:
        parts = [leaf.unbind(0) for leaf in self._leaves]
        return [tree_unflatten(self._treedef, [p[t] for p in parts])
                for t in range(len(parts[0]))]

    def gather(self, tree: Any) -> Any:
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [
            _gather(leaf, pl, self._mesh, self._grad)
            for leaf, pl in zip(leaves, self._placements, strict=True)])


def _model_params(stored: dict, local: dict, mesh, grad_placements) -> dict:
    """The params tree the model reads: each stack's periods as
    ``ShardedPeriods``, every other leaf gathered."""

    def gather_all(s, loc):
        s_leaves, treedef = tree_flatten(s)
        return tree_unflatten(treedef, [
            _gather(x, d.placements, mesh, grad_placements)
            for d, x in zip(s_leaves, tree_flatten(loc)[0], strict=True)])

    out = {}
    for key, sub in stored.items():
        if isinstance(sub, dict) and "periods" in sub:
            out[key] = {k: (ShardedPeriods(v, local[key][k], mesh,
                                           grad_placements)
                            if k == "periods" else gather_all(v, local[key][k]))
                        for k, v in sub.items()}
        else:
            out[key] = gather_all(sub, local[key])
    return out


def make_sharded_train_step(model: Model, mesh,
                            opt_cfg: AdamWConfig | None = None,
                            n_micro: int = 1) -> Callable:
    """``(state, batch) -> (state, metrics)`` on a ``TrainState`` of
    DTensors (``distribute_tree`` at ``Policy.param_specs`` /
    ``opt_specs``) and a batch of DTensors (``batch_specs``): forward,
    backward and AdamW, as ``train.step.make_train_step`` on the global
    batch.  The metrics are the global batch's (summed over the data
    ranks)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def value_and_grad(params_dt, local, batch, split):
        treedef = tree_flatten(params_dt)[1]
        mparams = _model_params(params_dt, tree_unflatten(treedef, local),
                                mesh, split.grad_placements)
        loss, metrics = model.loss(mparams, batch, dist=split)
        grads = torch.autograd.grad(loss, local, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, local, strict=True)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        split = DataSplit.of(batch, mesh)
        leaves_dt, treedef = tree_flatten(state.params)
        local = [d.to_local().detach().requires_grad_(True)
                 for d in leaves_dt]
        lbatch = local_tree(batch)
        if n_micro == 1:
            loss, metrics, grads = value_and_grad(state.params, local,
                                                  lbatch, split)
            metrics = {k: (v if k == "tokens" else split.sum(v))
                       for k, v in metrics.items()}
        else:
            g_sum = [torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device) for x in local]
            toks = torch.zeros((), dtype=torch.float32,
                               device=local[0].device)
            loss_sum = torch.zeros_like(toks)
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                  + tuple(v.shape[1:]))
                     for k, v in lbatch.items()}
            for i in range(n_micro):
                loss, met, g = value_and_grad(
                    state.params, local, {k: v[i] for k, v in micro.items()},
                    split)
                w = met["tokens"]
                g_sum = [a + b.to(torch.float32) * w
                         for a, b in zip(g_sum, g, strict=True)]
                toks = toks + w
                loss_sum = loss_sum + loss * w
            toks = torch.clamp(toks, min=1.0)
            grads = [g / toks for g in g_sum]
            metrics = {"loss": split.sum(loss_sum / toks), "tokens": toks}
        grads_dt = tree_unflatten(treedef, [
            DTensor.from_local(g, mesh, d.placements, run_check=False)
            for g, d in zip(grads, leaves_dt, strict=True)])
        new_params, new_opt, stats = adamw_update(grads_dt, state.opt,
                                                  state.params, opt_cfg)
        metrics = dict(metrics)
        metrics.update({k: v.full_tensor() if isinstance(v, DTensor) else v
                        for k, v in stats.items()})
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step


def _prefill_caches_as_dtensors(caches: Any, split: DataSplit) -> Any:
    leaves, treedef = tree_flatten(caches)
    return tree_unflatten(treedef, [
        split.as_dtensor(c, 1 if ("key", "periods") in path else 0)
        for path, c in zip(tree_paths(caches), leaves, strict=True)])


def make_sharded_prefill_step(model: Model, mesh) -> Callable:
    """``(params, batch) -> (logits, caches)``: ``Model.prefill`` on this
    rank's rows, periods gathered one at a time; logits and caches come
    back as DTensors split over the data ranks."""

    def prefill_step(params, batch):
        split = DataSplit.of(batch, mesh)
        leaves_dt, treedef = tree_flatten(params)
        local = tree_unflatten(treedef, [d.to_local() for d in leaves_dt])
        with torch.no_grad():
            mparams = _model_params(params, local, mesh,
                                    split.grad_placements)
            logits, caches = model.prefill(mparams, local_tree(batch),
                                           dist=split)
        return split.as_dtensor(logits), _prefill_caches_as_dtensors(
            caches, split)

    return prefill_step


def _cache_view(local: torch.Tensor, placements, mesh) -> torch.Tensor:
    """A cache shard gathered over every mesh dimension but the batch's."""
    keep = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in placements]
    return DTensor.from_local(local, mesh, placements, run_check=False
                              ).redistribute(mesh, keep).to_local()


def _cache_commit(local: torch.Tensor, full: torch.Tensor, placements,
                  mesh) -> None:
    """Write this rank's shard of ``full`` (a ``_cache_view``) back."""
    keep = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in placements]
    local.copy_(DTensor.from_local(full, mesh, keep, run_check=False
                                   ).redistribute(mesh, placements
                                                  ).to_local())


class ShardedCachePeriods:
    """A decode's stored cache periods for ``transformer.apply_stack``:
    ``period(t)`` gathers period t's caches over the sequence (``model``),
    ``commit(t, caches)`` writes this rank's shard of them back."""

    def __init__(self, stored: Any, mesh):
        leaves, self._treedef = tree_flatten(stored)
        self._local = [d.to_local() for d in leaves]
        self._placements = [_shift(d.placements) for d in leaves]
        self._mesh = mesh

    def period(self, t: int) -> Any:
        return tree_unflatten(self._treedef, [
            _cache_view(x[t], pl, self._mesh)
            for x, pl in zip(self._local, self._placements, strict=True)])

    def commit(self, t: int, caches: Any) -> None:
        for x, full, pl in zip(self._local, tree_flatten(caches)[0],
                               self._placements, strict=True):
            _cache_commit(x[t], full, pl, self._mesh)


def make_sharded_decode_step(model: Model, mesh) -> Callable:
    """``(params, caches, inputs, pos) -> (logits, caches)``:
    ``Model.decode_step`` on this rank's rows (``inputs`` split over the
    data ranks), the caches stored at ``Policy.cache_specs`` and updated
    in place; ``pos`` is one position for every row, or a (B,) DTensor of
    them placed as the inputs.  Logits come back as a DTensor split over
    the data ranks."""

    def decode_step(params, caches, inputs, pos):
        split = DataSplit.of(inputs, mesh)
        leaves_dt, treedef = tree_flatten(params)
        local = tree_unflatten(treedef, [d.to_local() for d in leaves_dt])
        if isinstance(pos, DTensor):
            pos = pos.to_local()
        with torch.no_grad():
            mparams = _model_params(params, local, mesh,
                                    split.grad_placements)
            mcaches = {"periods": ShardedCachePeriods(caches["periods"],
                                                      mesh)}
            prefix = caches.get("prefix")
            if prefix is not None:
                p_leaves, p_def = tree_flatten(prefix)
                views = [_cache_view(d.to_local(), d.placements, mesh)
                         for d in p_leaves]
                mcaches["prefix"] = tree_unflatten(p_def, views)
            logits, _ = model.decode_step(mparams, mcaches,
                                          local_tree(inputs), pos)
            if prefix is not None:
                for d, full in zip(p_leaves, views, strict=True):
                    _cache_commit(d.to_local(), full, d.placements, mesh)
        return split.as_dtensor(logits), caches

    return decode_step
