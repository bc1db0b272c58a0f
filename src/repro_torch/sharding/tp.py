"""Tensor-parallel compute over the mesh's ``model`` axis.

No counterpart in the reference: there GSPMD shards the compute inside
``jax.jit`` along the policy's specs.  Here a sharded step
(``sharding/apply.py``) hands the model a ``MeshParallel``
(``models/parallel.py``'s contact object), whose groups and vocabulary
functions run the collectives:

  - **Autograd-aware collectives** over the ``model`` group, each the
    transpose of the other: ``_Copy`` (identity forward, all-reduce
    backward) for a replicated input entering column-parallel products,
    ``_Reduce`` (all-reduce forward, identity backward) for the partial
    outputs of row-parallel products (``wo``, ``w_down``); under
    ``seq_parallel`` ``_GatherSeq`` (all-gather on the sequence, reduce-
    scatter backward) and ``_ReduceScatterSeq`` (its transpose) in their
    place; ``_Total`` (all-reduce both ways) for a statistic each rank
    uses on its own channels (Mamba's gated norm over ``d_inner``), and
    ``_Once`` (identity forward, the gradient over the ranks backward) for
    a value every rank computes alike from inputs whose gradients the
    ranks sum (the MoE aux loss from the replicated router).  The encoder
    memory that split cross-attention projects enters through ``_Copy``
    under ``seq_parallel`` too (``kv_in``: it is whole on every rank).  A
    layer every rank computes whole (a head, expert or width count that
    does not divide, or a decode whose cache does not split the sequence)
    takes ``_GatherSplit`` (all-gather forward, this rank's slice
    backward) and ``_Split`` (its transpose) under ``seq_parallel``, and
    no collective otherwise.  Each
    is an autograd function over ``torch.distributed._functional_
    collectives`` with its backward written out; DTensor's redistributions
    stay in ``apply.py``'s per-leaf gathers.
  - **Vocabulary parallelism** where the embedding table splits over
    ``model`` (V % m == 0): the lookup masks the ids outside this rank's
    rows and all-reduces; the loss takes the all-reduced maximum, sum of
    exponentials and target logit (both routes, plain and ``ce_chunk``);
    the padded rows (>= ``vocab_size``, in the last rank's slice) keep
    ``lm_logits``' -1e30; prefill and decode gather full logits.

A loss that every rank of a ``model`` group computes whole, back-propagated
on every rank, then gives each rank the gradient of its own shards: the
all-reduces whose result every rank uses alike pass the gradient through
(``_Reduce``), and the inputs of split products sum it (``_Copy``).
"""

from __future__ import annotations

import copy

import torch
import torch.distributed._functional_collectives as funcol

from ..models.config import ModelConfig
from ..models.layers import dtype_of, take_targets
from ..models.parallel import Group, Parallel

__all__ = ["TPGroup", "WholeGroup", "MeshParallel"]


def _all_reduce(t: torch.Tensor, op: str, pg) -> torch.Tensor:
    return funcol.wait_tensor(funcol.all_reduce(t.contiguous(), op, pg))


def _all_gather(t: torch.Tensor, dim: int, pg) -> torch.Tensor:
    return funcol.wait_tensor(funcol.all_gather_tensor(
        t.contiguous(), dim % t.ndim, pg))


def _reduce_scatter(t: torch.Tensor, dim: int, pg) -> torch.Tensor:
    return funcol.wait_tensor(funcol.reduce_scatter_tensor(
        t.contiguous(), "sum", dim % t.ndim, pg))


def _own(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).contiguous()


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.pg), None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, pg):
        return _all_reduce(x, "sum", pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Total(torch.autograd.Function):
    """All-reduce (sum) forward and backward: each rank uses the sum on
    its own share, so the sum's gradient is the ranks' gradients summed."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _all_reduce(x, "sum", pg)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.pg), None


class _Once(torch.autograd.Function):
    """Identity forward, the gradient divided by the ranks backward."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _GatherSeq(torch.autograd.Function):
    """All-gather on ``dim`` forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _all_gather(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.pg), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    """Reduce-scatter on ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _reduce_scatter(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.pg), None, None


class _Split(torch.autograd.Function):
    """This rank's slice of ``dim`` forward, all-gather backward (a value
    every rank holds whole, split)."""

    @staticmethod
    def forward(ctx, x, dim, rank, size, pg):
        ctx.dim, ctx.pg = dim, pg
        return _own(x, dim, rank, size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.pg), None, None, None, None


class _GatherSplit(torch.autograd.Function):
    """All-gather on ``dim`` forward, this rank's slice backward (a value
    every rank then uses whole, alike)."""

    @staticmethod
    def forward(ctx, x, dim, rank, size, pg):
        ctx.dim, ctx.rank, ctx.size = dim, rank, size
        return _all_gather(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.rank, ctx.size), None, None, None, None


class TPGroup(Group):
    """The ``model`` ranks of this rank, splitting a layer's heads, MLP
    width or experts.  ``seq``: the residual stream is split on the sequence
    (``seq_parallel``), so inputs are all-gathered and outputs
    reduce-scattered."""

    def __init__(self, pg, rank: int, size: int, seq: bool = False):
        self.pg, self.rank, self.size, self.seq = pg, rank, size, seq

    def col_in(self, x):
        if self.seq:
            return _GatherSeq.apply(x, 1, self.pg)
        return _Copy.apply(x, self.pg)

    def kv_in(self, x):
        # Whole on every rank, under ``seq_parallel`` too: only the
        # gradient is summed.
        return _Copy.apply(x, self.pg)

    def row_product(self, fn, a, w):
        # The partial sums in f32, reduced in f32 and rounded once by the
        # caller, as the whole product accumulates in f32 and rounds once:
        # bf16 partials summed in bf16 round three times, and over
        # Qwen2-1.5B's 28 layers that drift left the bf16 tolerance.
        return fn(a.float(), w.float())

    def row_out(self, y):
        if self.seq:
            return _ReduceScatterSeq.apply(y, 1, self.pg)
        return _Reduce.apply(y, self.pg)

    def gather(self, t, dim):
        return _all_gather(t, dim, self.pg)

    def sum(self, t):
        return _all_reduce(t, "sum", self.pg)

    def max(self, t):
        return _all_reduce(t, "max", self.pg)

    def total(self, t):
        return _Total.apply(t, self.pg)

    def once(self, t):
        return _Once.apply(t, self.size)


class WholeGroup(Group):
    """A layer every ``model`` rank computes whole (``size`` 1: no head is
    split); under ``seq`` its input is gathered and its output split."""

    def __init__(self, pg, rank: int, size: int, seq: bool = False):
        self._pg, self._rank, self._size, self.seq = pg, rank, size, seq

    def col_in(self, x):
        if self.seq:
            return _GatherSplit.apply(x, 1, self._rank, self._size, self._pg)
        return x

    def row_out(self, y):
        if self.seq:
            return _Split.apply(y, 1, self._rank, self._size, self._pg)
        return y


class MeshParallel(Parallel):
    """A sharded step's contact object (``models/parallel.py``).

    ``periods`` and ``cache_periods`` take the provider objects the step
    put in the model's trees (``apply.ShardedPeriods`` and
    ``apply.ShardedCachePeriods``); ``split`` gives the ``model`` group
    where a leaf's local size is its global one over the axis's size;
    ``moe_tokens``/``moe_rows`` are the data split's (``apply.DataSplit``).
    ``seq_parallel``: inside a stack's periods the residual stream is split
    on the sequence over ``model`` (training)."""

    def __init__(self, mesh, split, seq_parallel: bool = False):
        dim = list(mesh.mesh_dim_names).index("model")
        self.size = mesh.size(dim)
        self.rank = (mesh.get_coordinate() or [0] * mesh.ndim)[dim]
        self.pg = mesh.get_group(dim) if self.size > 1 else None
        self.data = split
        self.seq_parallel = seq_parallel and self.size > 1
        self._seq = False
        self._groups()

    def _groups(self) -> None:
        args = (self.pg, self.rank, self.size, self._seq)
        self._tp = TPGroup(*args)
        self._whole = WholeGroup(*args)

    # -- periods ---------------------------------------------------------
    def periods(self, periods):
        return periods.unbind(), periods.gather

    def cache_periods(self, periods):
        return periods

    # -- groups ----------------------------------------------------------
    def split(self, n_local: int, n_global: int) -> Group:
        if self.size > 1 and n_local * self.size == n_global:
            return self._tp
        return self._whole

    def seq_split(self, x):
        if not self.seq_parallel:
            return x
        if x.shape[1] % self.size:
            raise ValueError(f"seq_parallel: the sequence ({x.shape[1]}) "
                             f"must divide over the model axis ({self.size})")
        return _Split.apply(x, 1, self.rank, self.size, self.pg)

    def seq_gather(self, x):
        if not self.seq_parallel:
            return x
        return _GatherSplit.apply(x, 1, self.rank, self.size, self.pg)

    def in_periods(self) -> "MeshParallel":
        if not self.seq_parallel:
            return self
        inner = copy.copy(self)
        inner._seq = True
        inner._groups()
        return inner

    # -- vocabulary ------------------------------------------------------
    def _vocab(self, p: dict, cfg: ModelConfig):
        """The LM head as (d, V / m) and its first row, where the
        vocabulary is split over ``model``; else None."""
        head = p["head"] if "head" in p else p["table"].T
        if self.size > 1 and head.shape[1] * self.size == cfg.padded_vocab:
            return head, self.rank * head.shape[1]
        return None

    def embed_tokens(self, p, tokens, cfg):
        table = p["table"]
        n = table.shape[0]
        if self.size == 1 or n * self.size != cfg.padded_vocab:
            return super().embed_tokens(p, tokens, cfg)
        local = tokens - self.rank * n
        inside = (local >= 0) & (local < n)
        x = table[local.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
        return _Reduce.apply(x, self.pg)

    def _local_logits(self, x, head, start, cfg, float32=False):
        """This rank's columns of the logits of ``x`` (past ``_Copy``), the
        padded rows masked."""
        logits = (x @ head).to(torch.float32 if float32
                                else dtype_of(cfg.logit_dtype))
        if cfg.padded_vocab != cfg.vocab_size:
            ids = start + torch.arange(head.shape[1], device=x.device)
            if float32:
                return logits.masked_fill(ids >= cfg.vocab_size, -1e30)
            mask = torch.zeros((head.shape[1],), dtype=logits.dtype,
                               device=logits.device)
            mask[ids >= cfg.vocab_size] = -1e30
            logits = logits + mask
        return logits

    def lm_logits(self, p, x, cfg):
        v = self._vocab(p, cfg)
        if v is None:
            return super().lm_logits(p, x, cfg)
        logits = self._local_logits(_Copy.apply(x, self.pg), *v, cfg)
        return _GatherSplit.apply(logits, logits.ndim - 1, self.rank,
                                  self.size, self.pg)

    def _lse_target(self, lg, targets, start):
        """The all-reduced log-sum-exp and target logit of f32 local
        logits (B, S, V / m)."""
        n = lg.shape[-1]
        mx = _all_reduce(lg.detach().amax(dim=-1, keepdim=True), "max",
                         self.pg)
        se = _Reduce.apply(torch.exp(lg - mx).sum(dim=-1, keepdim=True),
                           self.pg)
        lse = (torch.log(se) + mx)[..., 0]
        local = targets.long() - start
        inside = (local >= 0) & (local < n)
        tl = take_targets(lg, local.clamp(0, n - 1)) * inside
        return lse, _Reduce.apply(tl, self.pg)

    def token_nll(self, p, x, targets, cfg):
        v = self._vocab(p, cfg)
        if v is None:
            return super().token_nll(p, x, targets, cfg)
        head, start = v
        lg = self._local_logits(_Copy.apply(x, self.pg), head, start,
                                cfg).float()
        lse, tl = self._lse_target(lg, targets, start)
        return lse - tl

    def chunked_ce(self, p, x, targets, w, cfg):
        v = self._vocab(p, cfg)
        if v is None:
            return super().chunked_ce(p, x, targets, w, cfg)
        head, start = v
        c = cfg.ce_chunk
        s = x.shape[1]
        pad = (-s) % c
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            targets = torch.nn.functional.pad(targets, (0, pad))
            w = torch.nn.functional.pad(w, (0, pad))
        x = _Copy.apply(x, self.pg)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s + pad, c):
            lg = self._local_logits(x[:, i:i + c], head, start, cfg,
                                    float32=True)
            lse, tl = self._lse_target(lg, targets[:, i:i + c], start)
            total = total + torch.sum((lse - tl) * w[:, i:i + c])
        return total

    # -- MoE routing -----------------------------------------------------
    def moe_tokens(self, h):
        return self.data.gather_rows(h)

    def moe_rows(self, y):
        return self.data.own_rows(y)
