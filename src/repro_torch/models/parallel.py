"""The one object between the model code and sharding: how a step's compute
is split.

The model code (``model.py``, ``transformer.py``, ``attention.py``) takes a
``Parallel`` and asks it for:

  - **periods**: a stack's per-period parameter trees and the function that
    makes one ready for its layers (``periods``), and a decode's cache
    periods (``cache_periods``: ``period(t)``, ``commit(t, caches)``);
  - **groups**: ``split(n_local, n_global)`` gives the ``Group`` that splits a
    layer's heads, MLP width or experts (a leaf's local size against its
    global one), or of a layer every rank computes whole where they do
    not divide.  A group's ``col_in`` enters a column-parallel product
    (``kv_in`` an input held whole under ``seq_parallel`` too: the encoder
    memory), ``row_product`` forms a row-parallel one and ``row_out``
    completes it
    (the caller casts it to the stream's dtype); ``rank``/``size`` say
    which heads (or experts) are this rank's, ``gather``/``sum``/``max``
    combine a decode's partial softmaxes, ``total`` a statistic over the
    split channels (Mamba's gated norm), and ``once`` counts the gradient
    of a value every rank computes alike (the MoE aux loss) once;
  - **the vocabulary**: ``embed_tokens``, ``lm_logits`` (full logits),
    ``token_nll`` and ``chunked_ce`` (the loss's two routes);
  - **the residual stream between periods** (training): ``seq_split`` /
    ``seq_gather`` around a stack's periods, and ``in_periods()``, the
    object for the layers inside them;
  - **MoE routing**: ``moe_tokens`` / ``moe_rows``, the global token set of
    a batch split over data ranks and this rank's rows of the result.

``SINGLE`` is one device: every hook is the identity, and the model runs
exactly the ops it runs without it.  A sharded step passes its own
(``sharding/tp.py::MeshParallel``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..tree import tree_flatten, tree_map, tree_unflatten
from .config import ModelConfig
from .layers import chunked_ce, embed_tokens, lm_logits, take_targets

__all__ = ["Group", "SOLO", "Parallel", "SINGLE", "unbind_periods",
           "index_periods"]


class Group:
    """The ranks that split one layer's heads (or MLP width) between them.
    This base class is one rank: every operation is the identity."""

    rank = 0
    size = 1

    def col_in(self, x: torch.Tensor) -> torch.Tensor:
        """The input of column-parallel products (each rank's columns)."""
        return x

    def kv_in(self, x: torch.Tensor) -> torch.Tensor:
        """An input every rank holds whole whatever the stream's split (the
        encoder memory of cross-attention), entering column-parallel
        products."""
        return x

    def row_product(self, fn: Callable, a: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
        """A row-parallel product ``fn(a, w)`` (``wo``, ``w_down``): this
        rank's partial sum, which ``row_out`` completes."""
        return fn(a, w)

    def row_out(self, y: torch.Tensor) -> torch.Tensor:
        """The output of row-parallel products (each rank's partial sum)."""
        return y

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated on ``dim`` (no gradient)."""
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (no gradient)."""
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ranks (no gradient)."""
        return t

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, each of which then uses the sum on
        its own channels: differentiable, its gradient summed too."""
        return t

    def once(self, t: torch.Tensor) -> torch.Tensor:
        """A value every rank computes alike from inputs whose gradients
        the ranks sum (a split layer's input, the MoE router): the
        identity, its gradient divided by the ranks so that the sum counts
        it once."""
        return t


SOLO = Group()


def fields(cache) -> dict[str, Any]:
    """A cache dataclass's (``KVCache``, ``MambaCache``) tensors by name."""
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}


def index_periods(tree: Any, i: int) -> Any:
    """Period ``i`` of a stacked pytree (views: writes reach the stack)."""
    return tree_map(lambda t: t[i], tree)


def unbind_periods(tree: Any) -> list:
    """A stacked period pytree as one pytree per period.  ``unbind``'s
    backward stacks the per-period gradients in one op, where indexing
    period by period would add a zero-padded full-size gradient per
    period."""
    leaves, treedef = tree_flatten(tree)
    parts = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [p[t] for p in parts])
            for t in range(len(parts[0]))]


def _same(tree):
    return tree


class _StackedCaches:
    """A decode's stacked cache periods, updated in place."""

    def __init__(self, periods: Any):
        self._periods = periods

    def period(self, t: int) -> Any:
        return index_periods(self._periods, t)

    def commit(self, t: int, caches: Any) -> None:
        """The writes went to views of the stack already."""


class Parallel:
    """One device: the identity on every hook."""

    # -- periods ---------------------------------------------------------
    def periods(self, periods: Any) -> tuple[list, Callable]:
        """A stack's per-period parameter trees, and the function that makes
        one ready for its layers."""
        return unbind_periods(periods), _same

    def cache_periods(self, periods: Any):
        """A decode's cache periods: ``period(t)`` and ``commit(t,
        caches)``."""
        return _StackedCaches(periods)

    # -- groups ----------------------------------------------------------
    def split(self, n_local: int, n_global: int) -> Group:
        """The group that splits a dimension of ``n_global`` of which this
        rank holds ``n_local`` (heads, MLP width, experts)."""
        return SOLO

    # -- the residual stream between periods (training) ------------------
    def seq_split(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def in_periods(self) -> "Parallel":
        """The object for the layers of a stack's periods."""
        return self

    # -- vocabulary ------------------------------------------------------
    def embed_tokens(self, p: dict, tokens: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
        return embed_tokens(p, tokens, cfg)

    def lm_logits(self, p: dict, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
        """Full (B, S, V) logits."""
        return lm_logits(p, x, cfg)

    def token_nll(self, p: dict, x: torch.Tensor, targets: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
        """(B, S) f32 cross-entropy of each token's target."""
        lp = torch.log_softmax(lm_logits(p, x, cfg).float(), dim=-1)
        return -take_targets(lp, targets)

    def chunked_ce(self, p: dict, x: torch.Tensor, targets: torch.Tensor,
                   w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """The weighted cross-entropy sum over sequence chunks
        (``layers.chunked_ce``)."""
        return chunked_ce(p, x, targets, w, cfg)

    # -- MoE routing -----------------------------------------------------
    def moe_tokens(self, h: torch.Tensor) -> torch.Tensor:
        """The token set an MoE layer routes."""
        return h

    def moe_rows(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's rows of an MoE layer's output."""
        return y


SINGLE = Parallel()
