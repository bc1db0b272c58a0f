"""Per-grain gradient and train-step factories.

Port of ``repro/train/step.py``.  ``jax.value_and_grad`` becomes
``torch.autograd.grad`` over the params' leaves (detached copies that
require grad, so the caller's params never carry autograd state).

The reference's ``jax.jit`` on the grain gradient becomes
``serve/compiled.py``'s ``CompiledStep`` (``compile_steps=True``, the
default): on CUDA the forward, the remat recompute and the backward are
captured as one CUDA graph, K4's forward and backward kernels with them,
and replayed; the batch's tensors are the static inputs, and the params
are bound, as a graph keeps the addresses it was captured with.  One
grain shape serves every allotment the runtime can produce, so one graph
serves every grain.  ``compile_steps=False`` is the eager route, every op
dispatched from Python; the two give the same bits.

The homogenization grain weights ride in ``batch["loss_mask"]``; with
microbatch accumulation (``n_micro > 1``) the batch's leading dim is split
and looped over, gradients averaged with token-count weights (unbiased
under unequal grain allotment — the paper's client-side combine).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.model import Model
from ..optim.adamw import AdamWConfig, adamw_update
from ..serve.compiled import CompiledStep
from ..tree import tree_flatten, tree_map, tree_unflatten
from .train_state import TrainState

__all__ = ["make_grain_grad_fn", "GrainGradFn", "BatchSteps",
           "make_train_step", "make_prefill_step", "make_decode_step"]


def _value_and_grad(model: Model, params, batch, capacities=None):
    """((loss, metrics), grads) of ``model.loss`` at ``params``; every
    returned tensor is detached."""
    leaves, treedef = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, metrics = model.loss(tree_unflatten(treedef, leaves), batch,
                               capacities)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for g, leaf in zip(grads, leaves, strict=True)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(treedef, grads)


class BatchSteps:
    """``fn(batch)`` compiled once per batch signature (its keys, and each
    tensor's shape and dtype): the batch's tensors are the static inputs
    of a ``CompiledStep``, and whatever ``fn`` closes over is bound.  The
    result is the step's static outputs, which the next call overwrites
    (see ``CompiledStep``)."""

    def __init__(self, name: str, fn: Callable, device, pool=None,
                 stream=None):
        self.name = name
        self.fn = fn
        self.device = device
        self.pool = pool
        self.stream = stream
        self.steps: dict[tuple, CompiledStep] = {}

    def __call__(self, batch: dict):
        keys = tuple(sorted(batch))
        sig = tuple((k, tuple(batch[k].shape), batch[k].dtype) for k in keys)
        step = self.steps.get(sig)
        if step is None:
            fn = self.fn

            def run(*tensors):
                return fn(dict(zip(keys, tensors)))

            shapes = ",".join("x".join(map(str, batch[k].shape)) for k in keys)
            step = self.steps[sig] = CompiledStep(
                f"{self.name}[{shapes}]", run, self.device, pool=self.pool,
                stream=self.stream)
        return step(*(batch[k] for k in keys))


def _same_tensors(a, b) -> bool:
    """Two (treedef, [(leaf, its data_ptr)]) records of the same tensors
    over the same storage."""
    return a[0] == b[0] and len(a[1]) == len(b[1]) and all(
        x is y and p == q for (x, p), (y, q) in zip(a[1], b[1]))


class GrainGradFn:
    """The per-grain ``(params, batch) -> ((loss, metrics), grads)``.

    Compiled (the default): the graphs are bound to the params' leaves of
    the call that made them.  A call with leaves that are other tensors
    (or the same tensors over other storage) drops them and starts again
    at the warm-up, so no graph ever replays over parameters it was not
    captured with; an optimizer that writes its update into the same
    tensors (``adamw_update(in_place=True)``) keeps them.  The result is
    the graph's outputs, overwritten by the next grain: a caller that
    keeps one past the next call clones it (``loop._PrefixCombine``)."""

    def __init__(self, model: Model, compile_steps: bool = True, pool=None,
                 stream=None, name: str = "grain_grad"):
        self.model = model
        self.compile_steps = compile_steps
        self.pool = pool
        self.stream = stream
        self.name = name
        self.reset()

    def reset(self) -> None:
        """Drop the graphs (and the parameters they hold)."""
        self._bound: tuple | None = None
        self._steps: BatchSteps | None = None

    @property
    def steps(self) -> list[CompiledStep]:
        return [] if self._steps is None else list(self._steps.steps.values())

    def __call__(self, params, batch):
        if not self.compile_steps:
            return _value_and_grad(self.model, params, batch)
        leaves, treedef = tree_flatten(params)
        bound = (treedef, [(x, x.data_ptr()) for x in leaves])
        if self._bound is None or not _same_tensors(bound, self._bound):
            model = self.model
            self._bound = bound
            self._steps = BatchSteps(
                self.name, lambda b: _value_and_grad(model, params, b),
                model.device, pool=self.pool, stream=self.stream)
        return self._steps(batch)


def make_grain_grad_fn(model: Model, compile_steps: bool = True, *,
                       pool=None, stream=None) -> GrainGradFn:
    """Per-grain ``(params, batch) -> ((loss, metrics), grads)`` — the unit
    the HDP combine sums.  Every grain batch has the same fixed
    (grain_size, seq_len) shape.  ``compile_steps`` (the reference's
    ``jax.jit``): the first call runs eagerly (on CUDA on a side stream,
    returning its own result, so a one-off call stays eager), the second
    captures a CUDA graph and replays it, later calls replay; ``pool`` and
    ``stream`` are the graph pool and side stream it shares with a
    trainer's other compiled steps."""
    return GrainGradFn(model, compile_steps, pool=pool, stream=stream)


def make_train_step(
    model: Model, opt_cfg: AdamWConfig | None = None, n_micro: int = 1,
    capacities=None, *, in_place: bool = False,
) -> Callable:
    """``(state, batch) -> (state, metrics)``: forward, backward and AdamW,
    eager, as the reference's factory returns an un-jitted function.
    ``in_place`` writes the update into ``state``'s tensors and returns
    ``state`` itself (``adamw_update(in_place=True)``): the form
    ``train_single`` compiles, whose graph keeps the state's addresses."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if n_micro == 1:
            (loss, metrics), grads = _value_and_grad(
                model, state.params, batch, capacities)
        else:
            g_sum = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), state.params)
            toks = torch.zeros((), dtype=torch.float32,
                               device=state.opt["step"].device)
            loss_sum = torch.zeros_like(toks)
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            for i in range(n_micro):
                (loss, met), g = _value_and_grad(
                    model, state.params, {k: v[i] for k, v in micro.items()},
                    capacities)
                w = met["tokens"]
                # The reference promotes each gradient to f32 against the
                # f32 token weight before adding it to the f32 sum.
                g_sum = tree_map(lambda a, b: a + b.to(torch.float32) * w,
                                 g_sum, g)
                toks = toks + w
                loss_sum = loss_sum + loss * w
            toks = torch.clamp(toks, min=1.0)
            grads = tree_map(lambda g: g / toks, g_sum)
            loss = loss_sum / toks
            metrics = {"loss": loss, "tokens": toks}
        new_params, new_opt, stats = adamw_update(
            grads, state.opt, state.params, opt_cfg, in_place=in_place
        )
        metrics = dict(metrics)
        metrics.update(stats)
        if in_place:
            return state, metrics
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step



def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(params, caches, inputs, pos):
        return model.decode_step(params, caches, inputs, pos)

    return decode_step
