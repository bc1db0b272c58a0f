"""Sharded train, prefill and decode steps on DTensor, with tensor-parallel
compute over the mesh's ``model`` axis.

The counterpart of the reference's ``jax.jit(step, in_shardings=...,
out_shardings=...)`` (``repro/launch/dryrun.py::build_step``), built on
``torch.distributed.tensor``; GSPMD's sharding of the compute itself is
``sharding/tp.py``:

  - **Storage.** ``distribute_tree`` stores params, both AdamW moments and
    the decode caches as DTensors at the policy's placements
    (``sharding/policy.py``): each rank holds its share of the bytes.
  - **Per-period gathers** (``_plan``).  A step takes the model's periods
    one at a time, inside each period's checkpoint in training; the
    embedding, the norms and the prefix layers once a step.  A leaf of an
    attention, dense-MLP, embedding, MoE, Mamba, MLA or cross-attention
    group whose key leaves (``_TP_KEY``: ``wq``, ``w_down``, ``table``,
    ``w_gate`` and the shared expert's ``w_down``, ``wx`` and ``wdt``,
    ``wuq``) the policy splits over ``model`` is gathered over the data
    axes only and keeps its ``model`` shard: those layers compute
    tensor-parallel on this rank's heads, MLP columns, vocabulary rows,
    experts (or expert width) and Mamba heads; Mamba's ``wb``/``wc`` and
    MLA's ``wdq`` are gathered whole (``_WHOLE``).  Every other leaf is
    gathered whole (groups whose heads, width, experts or vocabulary do
    not divide), and its layer computes whole on every ``model`` rank.
  - **Gradients.**  Each leaf's gradient is ``Partial`` over the data axes
    (each data rank computed its own rows) and over ``model``: ``Shard``
    where a rank used only its own shard; ``Partial`` where each rank used
    part of a leaf replicated over ``model`` (``wk``/``wv``/``bk``/``bv``
    when the KV heads do not divide, ``q_norm``/``k_norm``, the MoE
    router, Mamba's per-head vectors, norm, conv and ``wb``/``wc``, MLA's
    front end ``wdq``/``q_norm``/``wdkv``/``wkr``/``kv_norm``, and a
    period's norms under ``seq_parallel``, which see this rank's
    positions);
    ``Replicate`` where every rank computed the same.  They return as
    reduce-scatters or all-reduces to the stored placements, and AdamW
    updates the shards; the global-norm clip takes the whole gradient's
    norm (DTensor reductions).
  - **Batch.** The batch is split over the data axes (``batch_specs``)
    and the same on every ``model`` rank.  The step divides the loss by
    the global weight sum and takes 1/n of the aux term (the MoE layers
    route the global token set, ``DataSplit``), so the data ranks' losses
    sum to the global batch's; a split MoE layer's ranks count its aux
    gradient 1/m each (``Group.once``), as they compute it alike.
  - **Decode.**  An attention, MLA or cross-attention layer's cache
    stays at ``Policy.cache_specs`` (the sequence over ``model``; the
    prefix layers' too): each rank attends every head over its own
    positions (``models/attention.py::_decode_split``, ``models/mla.py::
    _decode_split``) and the cache is never gathered.  A split Mamba layer
    reads its own heads of the state (``cache_specs`` splits it by heads)
    and the whole conv window (stored whole, as the reference's specs
    place it; were it split, it would be gathered each step and its shard
    written back: its channels do not split by heads).  A layer computed
    whole gathers its caches over ``model`` and writes its shard back, as
    do the attention, MLA and cross caches where the sequence does not
    divide (``_split_sequences``).  The prefill's caches come back at
    those placements.
  - ``seq_parallel`` (training): between the periods the residual stream
    is split on the sequence over ``model``, so each period's checkpoint
    keeps 1/m of its input.

With ``n_micro > 1`` the training step of an MoE model gives microbatch
i the global batch's rows [i B / n, (i + 1) B / n), as the reference
splits it, each data rank its share (one all-gather of the batch's rows a
step): the MoE capacities, drops and aux terms follow the reference's
partition.  Without MoE each rank splits its own rows, which gives the same
accumulated gradient.  On a (1, 1) mesh every step is bitwise the unsharded
one.
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
from .policy import Policy, is_spec, leaf_names, to_placements
from .tp import MeshParallel

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
    the batch does not divide).  ``MeshParallel`` routes an MoE layer's
    tokens through it."""

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


#: The groups that compute tensor-parallel, by the dict that holds them,
#: and the leaves (paths below it) whose placement over ``model`` decides:
#: the first must be split, and each other one present with it (an MoE
#: layer's shared expert; Mamba's heads, where ``wx``'s channels divide
#: and its heads do not) too.
_TP_KEY = {"attn": (("wq",),), "mlp": (("w_down",),), "embed": (("table",),),
           "moe": (("w_gate",), ("shared", "w_down")),
           "mamba": (("wx",), ("wdt",)), "mla": (("wuq",),),
           "cross": (("wq",),)}
#: Leaves of a tensor-parallel group gathered whole over ``model`` though
#: the policy splits them: Mamba's B and C projections (every head of a
#: group reads them; the policy splits their state columns) and MLA's
#: query down-projection (``q_norm`` normalizes its whole q_lora width).
_WHOLE = {("mamba", "wb"), ("mamba", "wc"), ("mla", "wdq")}
#: The groups whose split decode reads its cache's sequence split over
#: ``model`` (``Policy.cache_specs``): (kind, cache key, head leaf, the
#: cache's fields).
_SEQ_CACHED = (("attn", "self", "wq", ("k", "v")),
               ("mla", "self", "wuq", ("c_kv", "k_rope")),
               ("cross", "cross", "wq", ("k", "v")))
_NORMS = ("norm1", "norm2", "norm_cross")


def _model_dim(mesh) -> int:
    return list(mesh.mesh_dim_names).index("model")


def _on_model(placements, dim: int) -> bool:
    return dim >= 0 and isinstance(placements[dim], Shard)


class _Plan:
    """How a step reads each leaf of a params tree: the placements it is
    gathered to (``target``) and the placements of its gradient
    (``grad``), by path (``leaf_names``, the period axis dropped).

    ``kinds``: the groups that compute tensor-parallel in this step
    (a decode whose caches do not split the sequence leaves out
    ``attn``); ``seq``: ``seq_parallel``, so a period's norms see this
    rank's positions."""

    def __init__(self, stored: Any, mesh, split: DataSplit,
                 kinds=tuple(_TP_KEY), seq: bool = False):
        self.mesh, self.split, self.seq = mesh, split, seq
        self.mdim = _model_dim(mesh) if mesh.size(_model_dim(mesh)) > 1 \
            else -1
        leaves = tree_flatten(stored)[0]
        names = [tuple(leaf_names(p)) for p in tree_paths(stored)]
        self._stored = {n: _shift(d.placements) if "periods" in n
                        else list(d.placements)
                        for n, d in zip(names, leaves, strict=True)}
        # A group computes tensor-parallel where its key leaves are split
        # over ``model``.
        self.tp_groups = set()
        for n, pl in self._stored.items():
            kind = n[-2] if len(n) > 1 else ""
            if kind not in kinds or n[-1:] != _TP_KEY[kind][0] \
                    or not _on_model(pl, self.mdim):
                continue
            others = [self._stored.get(n[:-1] + rest)
                      for rest in _TP_KEY[kind][1:]]
            if all(o is None or _on_model(o, self.mdim) for o in others):
                self.tp_groups.add(n[:-1])

    def placements(self, names: tuple) -> tuple[list, list, list]:
        """(stored, target, grad) placements of the leaf at ``names``."""
        stored = self._stored[names]
        tp = names[:-1] in self.tp_groups or (
            names[-2:-1] == ("shared",) and names[:-2] in self.tp_groups)
        whole = names[-2:] in _WHOLE
        norm = self.seq and "periods" in names and names[-2] in _NORMS
        target, grad = [], []
        for i, p in enumerate(stored):
            if i != self.mdim:
                target.append(Replicate())
                grad.append(Partial() if i in self.split.dims
                            else Replicate())
            elif tp and isinstance(p, Shard) and not whole:
                target.append(p)
                grad.append(p)
            else:
                target.append(Replicate())
                grad.append(Partial() if tp or norm else Replicate())
        return stored, target, grad

    def gather(self, tree: Any, prefix: tuple = ()) -> Any:
        """Each local shard of ``tree`` (at path ``prefix``) gathered to
        its target placements."""
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [
            _gather(leaf, *self.placements(prefix + tuple(leaf_names(p))),
                    self.mesh)
            for leaf, p in zip(leaves, tree_paths(tree), strict=True)])


def _gather(local: torch.Tensor, placements, target, grad_placements,
            mesh) -> torch.Tensor:
    """A shard gathered to ``target``; the gradient returns to the shard
    from ``grad_placements``."""
    return DTensor.from_local(local, mesh, placements, run_check=False
                              ).redistribute(mesh, target).to_local(
        grad_placements=grad_placements)


class ShardedPeriods:
    """A stack's stored periods, handed to the model as its period
    provider (``MeshParallel.periods``): ``unbind`` gives each period's
    shards (views of ``local``, whose gradients stack in one op),
    ``gather`` a period's tensors at the plan's placements."""

    def __init__(self, local: Any, plan: _Plan, prefix: tuple):
        leaves, self._treedef = tree_flatten(local)
        self._leaves = leaves
        self._plan, self._prefix = plan, prefix

    def unbind(self) -> list:
        parts = [leaf.unbind(0) for leaf in self._leaves]
        return [tree_unflatten(self._treedef, [p[t] for p in parts])
                for t in range(len(parts[0]))]

    def gather(self, tree: Any) -> Any:
        return self._plan.gather(tree, self._prefix)


def _model_params(stored: dict, local: dict, plan: _Plan) -> dict:
    """The params tree the model reads: each stack's periods as
    ``ShardedPeriods``, every other leaf gathered by the plan."""
    out = {}
    for key, sub in stored.items():
        if isinstance(sub, dict) and "periods" in sub:
            out[key] = {k: (ShardedPeriods(local[key][k], plan,
                                           (key, "periods"))
                            if k == "periods"
                            else plan.gather(local[key][k], (key, k)))
                        for k in sub}
        else:
            out[key] = plan.gather(local[key], (key,))
    return out


def _local_params(params: Any) -> Any:
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [d.to_local() for d in leaves])


def _microbatches(lbatch: dict, n_micro: int, split: DataSplit,
                  global_rows: bool) -> list[dict]:
    """This rank's rows of each of ``n_micro`` microbatches.

    ``global_rows``: microbatch i is the global batch's rows [i B / n,
    (i + 1) B / n), as the reference splits the batch, each data rank
    holding its share of them in rank order, so that an MoE layer, which
    gathers the ranks' rows (``DataSplit.gather_rows``), routes the
    reference's token set: one all-gather of the batch's rows a step.
    Otherwise each rank splits its own rows; without MoE every microbatch
    partition gives the same token-weighted gradient sum."""
    if global_rows and split.n > 1:
        b = next(iter(lbatch.values())).shape[0] * split.n
        if b % (n_micro * split.n):
            raise ValueError(f"n_micro={n_micro}: the global batch ({b}) "
                             f"must divide over {n_micro} microbatches of "
                             f"{split.n} data ranks")
        whole = {k: split.as_dtensor(v).full_tensor()
                 for k, v in lbatch.items()}
        return [{k: v.reshape((n_micro, split.n, -1) + tuple(v.shape[1:]))[
            i, split.index] for k, v in whole.items()}
            for i in range(n_micro)]
    return [{k: v.reshape((n_micro, v.shape[0] // n_micro)
                          + tuple(v.shape[1:]))[i] for k, v in lbatch.items()}
            for i in range(n_micro)]


def make_sharded_train_step(model: Model, mesh,
                            opt_cfg: AdamWConfig | None = None,
                            n_micro: int = 1) -> Callable:
    """``(state, batch) -> (state, metrics)`` on a ``TrainState`` of
    DTensors (``distribute_tree`` at ``Policy.param_specs`` /
    ``opt_specs``) and a batch of DTensors (``batch_specs``): forward,
    backward and AdamW, as ``train.step.make_train_step`` on the global
    batch, tensor-parallel over ``model`` (and ``seq_parallel`` where the
    config asks for it).  The metrics are the global batch's (summed over
    the data ranks)."""
    opt_cfg = opt_cfg or AdamWConfig()
    seq = model.cfg.seq_parallel

    def value_and_grad(params_dt, local, batch, split):
        plan = _Plan(params_dt, mesh, split, seq=seq)
        par = MeshParallel(mesh, split, seq_parallel=seq)
        treedef = tree_flatten(params_dt)[1]
        mparams = _model_params(params_dt, tree_unflatten(treedef, local),
                                plan)
        _, met = model.loss(mparams, batch, par=par)
        # This rank's terms over the global weight sum; 1/n of the aux
        # term (an MoE layer's is the global token set's).
        wsum = torch.clamp(split.sum(batch["loss_mask"].float().sum()),
                           min=1.0)
        ce = met["ce"] * (met["tokens"] / wsum)
        aux = met["aux"] / split.n
        loss = ce + aux
        grads = torch.autograd.grad(loss, local, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, local, strict=True)]
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "aux": aux.detach(), "tokens": wsum.detach()}
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
            for mb in _microbatches(lbatch, n_micro, split,
                                    model.cfg.moe is not None):
                loss, met, g = value_and_grad(state.params, local, mb, split)
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


def _own_chunk(t: torch.Tensor, placements, shape, mesh) -> torch.Tensor:
    """This rank's chunk of ``t``, whose dimensions hold the global
    ``shape`` or already a rank's share of it, at ``placements`` over the
    mesh dimensions that do not split the batch."""
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and t.shape[p.dim] == shape[p.dim] \
                and mesh.size(i) > 1:
            n = shape[p.dim] // mesh.size(i)
            t = t.narrow(p.dim, coord[i] * n, n)
    return t.contiguous()


def _prefill_caches(model: Model, caches: Any, batch: Any, split: DataSplit,
                    mesh) -> Any:
    """The prefill's caches as DTensors at ``Policy.cache_specs``: the
    batch over the data ranks, the sequence (or a mamba state's heads) over
    ``model``; the caches the model built whole keep this rank's chunk,
    the split attention's came at it already."""
    leaves, treedef = tree_flatten(caches)
    cfg = model.cfg
    cross = None
    if cfg.is_enc_dec:
        tokens, cross = batch["tgt_tokens"], batch["src_embeds"].shape[1]
    else:
        tokens = batch["embeds" if cfg.input_mode == "embeds" else "tokens"]
    b, s = tokens.shape[0] * split.n, tokens.shape[1]
    meta = Model(model.cfg, device="meta").init_cache(b, s, cross_seq=cross)
    specs = Policy(model.cfg, mesh).cache_specs(meta)
    out = []
    for leaf, m, spec in zip(leaves, tree_flatten(meta)[0],
                             tree_flatten(specs, is_leaf=is_spec)[0],
                             strict=True):
        pl = to_placements(spec, mesh)
        keep = [p if i not in split.dims else Replicate()
                for i, p in enumerate(pl)]
        out.append(DTensor.from_local(
            _own_chunk(leaf, keep, tuple(m.shape), mesh), mesh, pl,
            run_check=False))
    return tree_unflatten(treedef, out)


def make_sharded_prefill_step(model: Model, mesh) -> Callable:
    """``(params, batch) -> (logits, caches)``: ``Model.prefill`` on this
    rank's rows, tensor-parallel over ``model``, periods gathered one at a
    time; full logits come back as a DTensor split over the data ranks,
    the caches at ``Policy.cache_specs``."""

    def prefill_step(params, batch):
        split = DataSplit.of(batch, mesh)
        with torch.no_grad():
            mparams = _model_params(params, _local_params(params),
                                    _Plan(params, mesh, split))
            logits, caches = model.prefill(mparams, local_tree(batch),
                                           par=MeshParallel(mesh, split))
        return split.as_dtensor(logits), _prefill_caches(
            model, caches, local_tree(batch), split, mesh)

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


def _cache_names(path: tuple) -> tuple:
    """A cache leaf's dict keys, list indices (``i<n>``) and dataclass
    field (``("pos0", "self", "k")``, ``("i0", "self", "c_kv")``)."""
    return tuple(f"i{k}" if kind == "index" else str(k)
                 for kind, k in path if kind in ("key", "attr", "index"))


class ShardedCachePeriods:
    """A decode's stored cache periods, handed to the model as its cache
    provider (``MeshParallel.cache_periods``): ``period(t)`` gives period
    t's caches, the split layers' own shards as they are (the model writes
    them in place: a split attention layer's K and V, a split Mamba
    layer's state) and every other cache gathered over ``model`` (a Mamba
    layer's conv window too); ``commit(t, caches)`` writes this rank's
    shard of the gathered ones back."""

    def __init__(self, stored: Any, mesh, own=frozenset()):
        leaves, self._treedef = tree_flatten(stored)
        self._local = [d.to_local() for d in leaves]
        self._placements = [_shift(d.placements) for d in leaves]
        self._own = [_cache_names(p) in own for p in tree_paths(stored)]
        self._mesh = mesh

    def period(self, t: int) -> Any:
        return tree_unflatten(self._treedef, [
            x[t] if own else _cache_view(x[t], pl, self._mesh)
            for x, pl, own in zip(self._local, self._placements, self._own,
                                  strict=True)])

    def commit(self, t: int, caches: Any) -> None:
        for x, full, pl, own in zip(self._local, tree_flatten(caches)[0],
                                    self._placements, self._own,
                                    strict=True):
            if not own:
                _cache_commit(x[t], full, pl, self._mesh)


def _split_sequences(params: Any, caches: Any, mesh
                     ) -> tuple[frozenset, frozenset]:
    """The caches (``_cache_names``; a prefix layer's under ``i<n>``) of
    the attention, MLA and cross-attention layers a decode splits over
    ``model``, those whose heads the policy splits and whose cache splits
    the sequence, and their kinds (``_SEQ_CACHED``)."""
    mdim = _model_dim(mesh)
    if mesh.size(mdim) == 1:
        return frozenset(), frozenset()
    layers = list(caches["periods"].items())
    layers += [(f"i{i}", c) for i, c in enumerate(caches.get("prefix", ()))]
    stack = params["stack"]
    names, kinds = set(), set()
    for key, layer in layers:
        lp = (stack["periods"][key] if key in stack["periods"]
              else stack["prefix"][int(key[1:])])
        for kind, ckey, head, fields in _SEQ_CACHED:
            if kind not in lp or ckey not in layer:
                continue
            seq = getattr(layer[ckey], fields[0]).placements
            if _on_model(lp[kind][head].placements, mdim) and _on_model(
                    seq, mdim):
                names |= {(key, ckey, f) for f in fields}
                kinds.add(kind)
    return frozenset(names), frozenset(kinds)


def _split_states(plan: _Plan, caches: Any) -> frozenset:
    """The state (``_cache_names``) of each Mamba layer whose heads
    ``plan`` splits: ``Policy.cache_specs`` splits it by the same heads,
    so a decode keeps this rank's shard."""
    out = set()
    for names in plan.tp_groups:
        if names[-1] != "mamba" or names[:2] != ("stack", "periods"):
            continue
        key = names[2]
        state = caches["periods"][key]["self"].state
        if not _on_model(state.placements, plan.mdim):
            raise ValueError(f"decode: {key}'s Mamba heads are split over "
                             f"model, its state stored at "
                             f"{state.placements}")
        out.add((key, "self", "state"))
    return frozenset(out)


def make_sharded_decode_step(model: Model, mesh) -> Callable:
    """``(params, caches, inputs, pos) -> (logits, caches)``:
    ``Model.decode_step`` on this rank's rows (``inputs`` split over the
    data ranks), tensor-parallel over ``model``, the caches stored at
    ``Policy.cache_specs`` and updated in place (an attention layer's
    over its own share of the sequence); ``pos`` is one position for every
    row, or a (B,) DTensor of them placed as the inputs.  Full logits come
    back as a DTensor split over the data ranks."""

    def decode_step(params, caches, inputs, pos):
        split = DataSplit.of(inputs, mesh)
        if isinstance(pos, DTensor):
            pos = pos.to_local()
        own, seq_kinds = _split_sequences(params, caches, mesh)
        plan = _Plan(params, mesh, split, tuple(
            k for k in _TP_KEY
            if k in seq_kinds or k not in {c[0] for c in _SEQ_CACHED}))
        own |= _split_states(plan, caches)
        with torch.no_grad():
            mparams = _model_params(params, _local_params(params), plan)
            mcaches = {"periods": ShardedCachePeriods(caches["periods"],
                                                      mesh, own)}
            prefix = caches.get("prefix")
            if prefix is not None:
                p_leaves, p_def = tree_flatten(prefix)
                p_own = [_cache_names(p) in own for p in tree_paths(prefix)]
                views = [d.to_local() if o else
                         _cache_view(d.to_local(), d.placements, mesh)
                         for d, o in zip(p_leaves, p_own, strict=True)]
                mcaches["prefix"] = tree_unflatten(p_def, views)
            logits, _ = model.decode_step(mparams, mcaches,
                                          local_tree(inputs), pos,
                                          par=MeshParallel(mesh, split))
            if prefix is not None:
                for d, full, o in zip(p_leaves, views, p_own, strict=True):
                    if not o:
                        _cache_commit(d.to_local(), full, d.placements, mesh)
        return split.as_dtensor(logits), caches

    return decode_step
