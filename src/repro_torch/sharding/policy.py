"""Sharding policies: parameter / optimizer / batch / cache specs.

Port of ``repro/sharding/policy.py``, with its rules leaf name for leaf
name.  A spec is a tuple with one entry per dimension of the leaf: None
(replicated), a mesh axis name, or a tuple of axis names (the dimension
split over all of them, major first) — the entries of the reference's
``PartitionSpec``.  The policy builds its specs from a ``MeshShape`` or a
``DeviceMesh`` (``launch/mesh.py``) and walks the port's trees
(``repro_torch.tree``); ``to_placements`` turns a spec into DTensor
placements, where the reference makes a ``NamedSharding``.

Two policies (cfg.sharding_policy):
  tp       — weights shard on heads/ff/experts/vocab over the `model` axis;
             replicated over data.
  fsdp_tp  — additionally shard the d_model (reduction) dim of every matrix
             and all Adam moments over the data axes (ZeRO-ish).

Decode caches shard batch over the data axes and *sequence over `model`*;
mamba states shard heads, conv windows channels, over `model`.

A dim shards over an axis only if it divides evenly; otherwise that dim is
replicated.

How the port computes under these specs (``sharding/apply.py``,
``sharding/tp.py``): the specs place the stored state; each step gathers a
period's parameters at a time over the data axes, and the attention,
dense-MLP, embedding, head, MoE (experts, or their ``ff`` width), Mamba,
MLA and cross-attention (heads) leaves keep their ``model`` shards and
compute tensor-parallel on them, as the reference's GSPMD shards the
compute along the same specs.

``cache_specs`` names a leaf by its dict keys alone, as the reference's
``DictKey`` filter does, so a ``MambaCache``'s fields (``conv``,
``state``) never match their names: the state (B, H, P, N) takes the
attention branch, which splits dimension 1 (its heads, as meant), and the
conv window (B, d_conv - 1, C) the MLA branch, which splits dimension 1
(the window's d_conv - 1 = 3 positions: replicated at model 2, 4 and 8).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..launch.mesh import MeshShape
from ..models.config import ModelConfig
from ..tree import tree_flatten, tree_paths, tree_unflatten

__all__ = ["MeshAxes", "Policy", "to_placements", "is_spec", "leaf_names"]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: tuple[str, ...]          # ("data",) or ("pod", "data")
    tp: str = "model"

    @staticmethod
    def from_mesh(mesh) -> "MeshAxes":
        if "pod" in MeshShape.of(mesh).axis_names:
            return MeshAxes(dp=("pod", "data"))
        return MeshAxes(dp=("data",))


def is_spec(x) -> bool:
    """A spec is a tuple of None / axis names / tuples of axis names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _axis_size(sizes: dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def leaf_names(path: tuple, kinds=("key", "index")) -> list[str]:
    """The reference's leaf names: dict keys, and list indices as ``i<n>``
    (``DictKey`` and ``SequenceKey``)."""
    out = []
    for kind, k in path:
        if kind not in kinds:
            continue
        out.append(str(k) if kind == "key" else f"i{k}")
    return out


def _map_specs(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` over every leaf, in a tree of ``tree``'s
    structure."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(p, leaf) for p, leaf
                                    in zip(tree_paths(tree), leaves,
                                           strict=True)])


def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that a tensor dimension d is split over, ``Replicate()``
    on the others.  A tensor dimension split over several axes takes them
    major first, as the mesh orders its dimensions."""
    from torch.distributed.tensor import Replicate, Shard

    names = MeshShape.of(mesh).axis_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(d)
    return out


class Policy:
    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = MeshShape.of(mesh).shape
        self.axes = MeshAxes.from_mesh(mesh)
        self.fsdp = cfg.sharding_policy == "fsdp_tp"

    # -- helpers -------------------------------------------------------------
    def _dp_axis(self):
        return self.axes.dp if len(self.axes.dp) > 1 else self.axes.dp[0]

    def _dp(self, dim: int):
        """data-axes sharding for a dim, only under fsdp and if divisible."""
        ax = self._dp_axis()
        if self.fsdp and dim % _axis_size(self.sizes, ax) == 0:
            return ax
        return None

    def _tp(self, dim: int):
        return (self.axes.tp
                if dim % _axis_size(self.sizes, self.axes.tp) == 0 else None)

    def _dp_batch(self, dim: int):
        ax = self._dp_axis()
        return ax if dim % _axis_size(self.sizes, ax) == 0 else None

    # -- parameter specs ------------------------------------------------------
    def _leaf_spec(self, path: tuple[str, ...], shape: tuple[int, ...]
                   ) -> tuple:
        name = path[-1]
        parent = path[-2] if len(path) >= 2 else ""
        gparent = path[-3] if len(path) >= 3 else ""
        dp, tp = self._dp, self._tp

        # ---- embeddings
        if parent == "embed" or gparent == "embed":
            if name == "table":
                return (tp(shape[0]), dp(shape[1]))
            if name == "head":
                return (dp(shape[0]), tp(shape[1]))
        # ---- norms / small vectors
        if len(shape) <= 1:
            return (None,)
        # ---- attention
        if parent in ("attn", "cross"):
            if name in ("wq", "wk", "wv"):
                return (dp(shape[0]), tp(shape[1]), None)
            if name == "wo":
                return (tp(shape[0]), None, dp(shape[2]))
            if name in ("bq", "bk", "bv"):
                return (tp(shape[0]), None)
        # ---- MLA
        if parent == "mla":
            if name == "wdq":
                return (dp(shape[0]), tp(shape[1]))
            if name in ("wdkv", "wkr"):
                return (dp(shape[0]), None)
            if name in ("wuq", "wuk", "wuv"):
                return (None, tp(shape[1]), None)
            if name == "wo":
                return (tp(shape[0]), None, dp(shape[2]))
        # ---- MoE
        if parent == "moe" or (gparent == "moe" and parent == "shared"):
            if parent == "shared":
                if name in ("w_gate", "w_up"):
                    return (dp(shape[0]), tp(shape[1]))
                if name == "w_down":
                    return (tp(shape[0]), dp(shape[1]))
            if name == "router":
                return (dp(shape[0]), None)
            ep = tp(shape[0])  # expert-parallel if E % tp == 0
            if name in ("w_gate", "w_up"):
                if ep is not None:
                    return (ep, dp(shape[1]), None)
                return (None, dp(shape[1]), tp(shape[2]))
            if name == "w_down":
                if ep is not None:
                    return (ep, None, dp(shape[2]))
                return (None, tp(shape[1]), dp(shape[2]))
        # ---- Mamba
        if parent == "mamba":
            if name in ("wz", "wx", "wb", "wc", "wdt"):
                return (dp(shape[0]), tp(shape[1]))
            if name == "wo":
                return (tp(shape[0]), dp(shape[1]))
            if name in ("conv_w", "conv_b"):
                return (None,) * len(shape)
        # ---- dense MLP
        if parent == "mlp":
            if name in ("w_gate", "w_up"):
                return (dp(shape[0]), tp(shape[1]))
            if name == "w_down":
                return (tp(shape[0]), dp(shape[1]))
        return (None,) * len(shape)

    def param_specs(self, params: Any) -> Any:
        """A spec tree matching the param tree (tensors on any device, the
        meta device included).  Leaves under ``periods`` carry the stacked
        period axis first, never sharded."""

        def walk(path, leaf):
            names = leaf_names(path)
            shape = tuple(leaf.shape)
            if "periods" in names:
                return (None,) + self._leaf_spec(tuple(names), shape[1:])
            return self._leaf_spec(tuple(names), shape)

        return _map_specs(walk, params)

    # -- optimizer state: same layout as params (moments mirror param specs) --
    def opt_specs(self, params: Any) -> dict:
        ps = self.param_specs(params)
        return {"m": ps, "v": ps, "step": ()}

    # -- batches ---------------------------------------------------------------
    def batch_specs(self, batch: Any) -> Any:
        def spec(_, leaf):
            shape = tuple(leaf.shape)
            if not shape:
                return ()
            return (self._dp_batch(shape[0]),) + (None,) * (len(shape) - 1)

        return _map_specs(spec, batch)

    # -- decode caches -----------------------------------------------------------
    def cache_specs(self, caches: Any) -> Any:
        """(B, S, ...) caches: batch over dp, seq over model; mamba states:
        batch over dp, heads/channels over model.  Leading period dim ->
        None.  Names are the dict keys alone, as the reference reads
        them."""

        def walk(path, leaf):
            names = leaf_names(path, kinds=("key",))
            shape = tuple(leaf.shape)
            stacked = "periods" in names
            if stacked:
                shape = shape[1:]
            is_mamba = len(shape) in (3, 4) and (
                names and names[-1] in ("conv", "state"))
            b, tp = self._dp_batch, self._tp
            if is_mamba and names[-1] == "state":       # (B, H, P, N)
                base = (b(shape[0]), tp(shape[1]), None, None)
            elif is_mamba:                              # (B, w, C)
                base = (b(shape[0]), None, tp(shape[2]))
            elif len(shape) == 4:                       # attn k/v (B,S,H,D)
                base = (b(shape[0]), tp(shape[1]), None, None)
            elif len(shape) == 3:                       # mla (B,S,r)
                base = (b(shape[0]), tp(shape[1]), None)
            else:
                base = (None,) * len(shape)
            return (None,) + base if stacked else base

        return _map_specs(walk, caches)
