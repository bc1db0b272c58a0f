"""Per-grain gradient and train-step factories.

Port of ``repro/train/step.py``.  ``jax.value_and_grad`` becomes
``torch.autograd.grad`` over the params' leaves (detached copies that
require grad, so the caller's params never carry autograd state); there is
no ``jit``: PyTorch runs eagerly and one grain shape serves every
allotment the runtime can produce.

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
from ..tree import tree_flatten, tree_map, tree_unflatten
from .train_state import TrainState

__all__ = ["make_grain_grad_fn", "make_train_step"]


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


def make_grain_grad_fn(model: Model) -> Callable:
    """Per-grain ``(params, batch) -> ((loss, metrics), grads)`` — the unit
    the HDP combine sums.  Every grain batch has the same fixed
    (grain_size, seq_len) shape."""
    def grad_fn(params, batch):
        return _value_and_grad(model, params, batch)

    return grad_fn


def make_train_step(
    model: Model, opt_cfg: AdamWConfig | None = None, n_micro: int = 1,
    capacities=None,
) -> Callable:
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
            grads, state.opt, state.params, opt_cfg
        )
        metrics = dict(metrics)
        metrics.update(stats)
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step

