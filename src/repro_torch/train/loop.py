"""Training loops: single-worker and HDP (Homogenized Data Parallel).

Port of ``repro/train/loop.py``: the same runtime-driven trainer over the
port's copy of the control plane, with each grain's gradient computed by
PyTorch on the model's device (K4 and its backward kernels in every
attention layer on CUDA).

The reference jits three steps: the grain gradient, the AdamW update (its
optimizer state donated) and ``train_single``'s whole step (its state
donated).  With ``compile_steps=True`` (the default) each is a
``CompiledStep`` (``serve/compiled.py``), captured as a CUDA graph on the
card: the update writes the new parameters, moments and step into the
state's own tensors, so the grain graph reads the updated parameters at
the addresses it was captured with and nothing is copied (the port's
donation); it reads the combined gradients from buffers the trainer owns,
into which the combine folds every step.  A trainer's graphs share one
graph pool.  A new ``TrainState`` (a restore) drops them.
``compile_steps=False`` is the eager route; the two give the same bits.
The reference's description follows.

HDP is the paper's TDA mapped onto pods, *runtime-driven*: each training step
is one job on the shared ``core/runtime.py`` event loop.

  - the *coordinator* (TDA server) owns an ``AsyncRuntime`` + a
    ``PerformanceTracker``; each step's microbatch grains stream through
    per-pod queues, and every grain completion is a heartbeat (the paper's
    background process) — the perf vector tracks *current* pod speed at grain
    granularity, not step granularity,
  - a pod that slows down **mid-step** triggers hysteresis-gated migration of
    its unstarted grains to faster queues (and drained pods steal work), so
    the step still crosses the homogenization line instead of dragging at the
    straggler's pace until the next replan,
  - the *combine* (client edge of the triangle) is a token-weighted average
    of **per-grain** gradients, summed in grain-id order — a pure function of
    the grain data.  Grain→pod migration changes timing, never numerics:
    adaptive and static schedules produce bitwise-identical updates (on the
    card this rests on every grain's gradient being the same bits each time
    it runs: K4's backward uses no atomics),
  - fault tolerance: async atomic checkpoints carry the tracker's EMA table
    and the fleet clock as sidecar ``extras``; a restarted coordinator starts
    from *learned* perfs — its first plan equals the plan a never-killed
    coordinator would produce,
  - ``HDPConfig.adaptive=False`` freezes each step to its initial plan (the
    static per-step baseline the adaptive path is measured against); both
    modes are the same event loop, differing only in whether mid-step
    re-homogenization and stealing are armed,
  - scripted ``TimelineEvent``s (``HDPTrainer.schedule``) drive mid-step perf
    shifts / kills / joins exactly the way they drive ``ClusterSim``.

Pods execute sequentially on one device and *simulated* wall time
(grains/perf + the paper's O(L) overhead) drives the scheduler — numerics are
real, timing is modeled, exactly like core/simulate.py — unless a measuring
backend (``core/wallclock.py``) times each grain's real gradient work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..checkpoint.checkpoint import AsyncCheckpointer, read_extras, restore
from ..core.homogenization import OverheadModel
from ..core.performance import PerformanceTracker
from ..core.runtime import AsyncRuntime, GrainExecutor, TimelineEvent
from ..core.scheduler import GrainPlan
from ..data.pipeline import GrainSpec, SyntheticSource, batch_from_grains
from ..models.model import Model
from ..optim.adamw import AdamWConfig, adamw_update
from ..optim.grad_compress import ef_compress_tree, init_residuals
from ..serve.compiled import CompiledStep, new_pool
from ..tree import tree_leaves, tree_map
from .step import BatchSteps, make_grain_grad_fn, make_train_step
from .train_state import TrainState, init_train_state

__all__ = ["train_single", "Pod", "HDPConfig", "HDPTrainer"]


# --------------------------------------------------------------- single worker
def train_single(
    model: Model, n_steps: int, batch_fn: Callable[[int], dict],
    opt_cfg: AdamWConfig | None = None, ckpt_dir: str | None = None,
    ckpt_every: int = 100, log_every: int = 10, seed: int = 0,
    log_fn: Callable[[int, dict], None] | None = None,
    compile_steps: bool = True,
) -> tuple[TrainState, list[dict]]:
    """``n_steps`` steps of ``make_train_step`` from ``model.init(seed)``
    (or the last checkpoint in ``ckpt_dir``).  ``compile_steps``: the step
    is compiled per batch shape, its state bound and updated in place (the
    reference's ``jax.jit(..., donate_argnums=0)``); the state returned is
    the one the run started from, holding the last step's values."""
    opt_cfg = opt_cfg or AdamWConfig()
    state = init_train_state(model.init(seed))
    start = 0
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir:
        restored, rstep = restore(ckpt_dir, state)
        if restored is not None:
            state, start = restored, rstep
    step_fn = make_train_step(model, opt_cfg, in_place=compile_steps)
    if compile_steps:
        bound = state
        compiled = BatchSteps("train_single", lambda b: step_fn(bound, b)[1],
                              model.device, pool=new_pool(model.device))
    history = []
    for step in range(start, n_steps):
        if compile_steps:
            metrics = compiled(batch_fn(step))
        else:
            state, metrics = step_fn(state, batch_fn(step))
        if step % log_every == 0 or step == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            history.append(m)
            if log_fn:
                log_fn(step, m)
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.wait()
    return state, history


# ------------------------------------------------------------------------- HDP
@dataclasses.dataclass
class Pod:
    """A training pod doubles as a runtime worker: ``name`` + mutable *true*
    ``perf`` (hidden from the scheduler, which only sees heartbeats)."""

    name: str
    perf: float
    alive: bool = True


@dataclasses.dataclass(frozen=True)
class HDPConfig:
    total_grains: int
    grain_spec: GrainSpec
    homogenize: bool = True
    adaptive: bool = True          # mid-step migration/stealing (vs static plan)
    compress_grads: bool = False
    overhead: OverheadModel = dataclasses.field(
        default_factory=lambda: OverheadModel(m=200.0)
    )
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    replan_threshold: float = 0.05
    jitter: float = 0.0
    seed: int = 0


class _PrefixCombine:
    """Token-weighted fold of per-grain gradients in strict grain-id order,
    fed by *completion* order.  Out-of-order completions buffer until the
    prefix is contiguous, then fold and drop — so the update stays a pure
    function of grain data (bitwise independent of grain→pod assignment and
    timing) while peak buffered gradients track the fleet's completion skew,
    not ``total_grains``.  Sums stay in the gradients' dtype (bf16 for bf16
    params), as in the reference; they are taken in place in the running
    sum (each step rounds as the reference's ``a + x * w``), so a fold holds
    one sum, not two.  The first fold writes its ``x * w`` into ``out`` (a
    tree like the gradients: the buffers a compiled update reads), or into
    new tensors.  A grain that must wait for an earlier one is
    buffered as a copy: a compiled grain's gradients are its graph's
    outputs, which the next grain overwrites."""

    def __init__(self, compress: bool, residuals, out=None):
        self.compress = compress
        self.residuals = residuals
        self.out = out
        self.next_grain = 0
        self.pending: dict[int, tuple] = {}
        self.buffered = 0          # grains that waited in ``pending``
        self.most = 0              # the most grains waiting at once
        self.grads_sum = None
        self.tok_sum = 0.0
        self.loss_sum = 0.0

    def add(self, grain: int, loss: float, tokens: float, grads) -> None:
        if grain != self.next_grain:
            self.pending[grain] = (loss, tokens, tree_map(torch.clone, grads))
            self.buffered += 1
            self.most = max(self.most, len(self.pending))
            return
        self._fold(loss, tokens, grads)
        while self.next_grain in self.pending:
            self._fold(*self.pending.pop(self.next_grain))

    def _fold(self, loss: float, w: float, grads) -> None:
        if self.compress:
            grads, self.residuals = ef_compress_tree(grads, self.residuals)
        if self.grads_sum is None:
            self.grads_sum = tree_map(torch.empty_like, grads) \
                if self.out is None else self.out
            tree_map(lambda o, x: torch.mul(x, w, out=o), self.grads_sum,
                     grads)
        else:
            tree_map(lambda a, x: a.add_(x * w), self.grads_sum, grads)
        self.tok_sum += w
        self.loss_sum += loss * w
        self.next_grain += 1

    def grads(self, n_grains: int):
        if self.next_grain != n_grains:
            raise RuntimeError(
                f"combine folded {self.next_grain}/{n_grains} grains"
            )
        for x in tree_leaves(self.grads_sum):
            x.div_(self.tok_sum)
        return self.grads_sum


class _GrainGradExecutor(GrainExecutor):
    """The training-pod ``GrainExecutor``: real compute is one microbatch
    grain's gradient, folded straight into the step's ``_PrefixCombine``;
    simulated duration is cost/perf with ClusterSim's two-sided jitter
    convention (multiplier clamped positive).  The sim worker and the
    gradient-computing pod are two executors of one loop."""

    uniform_cost = 1.0

    def __init__(self, trainer: "HDPTrainer", step_idx: int,
                 combine: _PrefixCombine):
        self.trainer = trainer
        self.step_idx = step_idx
        self.combine = combine

    def duration_s(self, pod, cost, now_s):
        t = cost / max(pod.perf, 1e-12)
        jitter = self.trainer.cfg.jitter
        if jitter:
            t *= max(
                1.0 + jitter * float(self.trainer.rng.standard_normal()), 0.05
            )
        return t

    def execute(self, pod, grain):
        tr = self.trainer
        batch = batch_from_grains(
            tr.source, self.step_idx, [grain], tr.cfg.grain_spec,
            device=tr.model.device,
        )
        (loss, metrics), grads = tr._grad_fn(tr.state.params, batch)
        # float() waits for the device: a grain ends when its gradient is
        # computed, which is what a measuring backend's grain time covers.
        loss, tokens = float(loss), float(metrics["tokens"])
        self.combine.add(grain, loss, tokens, grads)
        return loss, tokens


class HDPTrainer:
    def __init__(self, model: Model, pods: list[Pod], cfg: HDPConfig,
                 opt_cfg: AdamWConfig | None = None, authority=None,
                 backend=None, eta_mode: str | None = None,
                 compile_steps: bool = True):
        self.model = model
        self.pods = {p.name: p for p in pods}
        self.cfg = cfg
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.tracker = PerformanceTracker(alpha=0.5, dead_after_s=1e7)
        self.source = SyntheticSource(cfg.grain_spec, seed=cfg.seed)
        # The compiled route's grain and update graphs share one graph pool
        # and one side stream.
        self.compile_steps = compile_steps
        self._pool = new_pool(model.device) if compile_steps else None
        self._stream = torch.cuda.Stream(model.device) if (
            compile_steps and model.device.type == "cuda") else None
        self._grad_fn = make_grain_grad_fn(model, compile_steps,
                                           pool=self._pool,
                                           stream=self._stream)
        self.state = init_train_state(model.init(cfg.seed))
        self.start_step = 0
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None
        clock = 0.0
        if cfg.ckpt_dir:
            restored, rstep = restore(cfg.ckpt_dir, self.state)
            if restored is not None:
                self.state, self.start_step = restored, rstep
                extras = read_extras(cfg.ckpt_dir, rstep)
                if extras is not None:
                    # Resume from *learned* perfs, not neutral priors: the
                    # first post-restart plan equals the plan a never-killed
                    # coordinator would produce.
                    if "tracker" in extras:
                        self.tracker.load_state_dict(extras["tracker"])
                    clock = float(extras.get("clock", 0.0))
        # Checkpointed workers that are not in this trainer's pod list stay
        # out of the fleet (their learned perf describes a pod we don't have).
        for name in self.tracker.workers():
            pod = self.pods.get(name)
            if pod is None or not pod.alive:
                self.tracker.mark_dead(name)
        live = [p for p in pods if p.alive]
        # ``authority`` shards the coordination plane (coord.
        # ShardedCoordinator); None keeps the single-coordinator default.
        # ``backend`` swaps grain timing: None keeps the modeled clock
        # (cfg.jitter applies); a measuring ExecutionBackend runs per-grain
        # device work and each grain's duration — including the real
        # gradient compute, folded in via observe_execute — is wall time, so
        # cfg.jitter's modeled noise no longer applies.
        self.runtime = AsyncRuntime(
            live,
            tracker=self.tracker,
            homogenize=cfg.homogenize,
            rehomogenize=cfg.adaptive and cfg.homogenize,
            steal=cfg.adaptive and cfg.homogenize,
            replan_threshold=cfg.replan_threshold,
            authority=authority,
            eta_mode=eta_mode,
            backend=backend,
        )
        self.runtime.clock = clock
        self.residuals = (
            init_residuals(self.state.params) if cfg.compress_grads else None
        )
        self.rng = np.random.default_rng(cfg.seed)
        self._timeline: list[TimelineEvent] = []
        self._step_hooks: list[Callable[[int, float], object]] = []
        self.history: list[dict] = []

    @property
    def clock(self) -> float:
        return self.runtime.clock

    # -- the state and the compiled steps ------------------------------------
    @property
    def state(self) -> TrainState:
        return self._state

    @state.setter
    def state(self, state: TrainState) -> None:
        """A new state drops the compiled steps, whose graphs keep the
        addresses of the state they were captured with, and the gradient
        buffers the update reads."""
        self._state = state
        self._grad_fn.reset()
        self._update: CompiledStep | None = None
        self._grads = None

    def _apply_update(self, grads) -> dict:
        """AdamW on the combined ``grads``; returns its stats.  Compiled: the
        state is written in place by a step bound to it and to ``grads``,
        the buffers every later step's combine folds into."""
        if not self.compile_steps:
            new_params, new_opt, stats = adamw_update(
                grads, self.state.opt, self.state.params, self.opt_cfg)
            self.state = TrainState(params=new_params, opt=new_opt)
            return stats
        if self._update is None:
            opt, params, cfg = self.state.opt, self.state.params, self.opt_cfg
            self._grads = grads
            self._update = CompiledStep(
                "update",
                lambda: adamw_update(grads, opt, params, cfg,
                                     in_place=True)[2],
                self.model.device, pool=self._pool, stream=self._stream)
        elif grads is not self._grads:
            raise RuntimeError("the combine folded into other buffers than "
                               "the compiled update reads")
        return self._update()

    # -- failure / straggler injection hooks (tests, examples) --------------
    def set_perf(self, pod: str, perf: float) -> None:
        """Between-step true-perf shift (the tracker learns it from the next
        step's heartbeats).  For a *mid-step* shift, ``schedule`` a
        TimelineEvent instead."""
        self.pods[pod].perf = perf

    def kill(self, pod: str) -> None:
        self.pods[pod].alive = False
        self.runtime.remove_worker(pod)

    def join(self, pod: Pod, perf_prior: float | None = None) -> None:
        """Between-step explicit (re)join; mid-step joins go through
        ``schedule(TimelineEvent(t, 'join', pod))``."""
        self.pods[pod.name] = pod
        pod.alive = True
        self.runtime.add_worker(pod, perf_prior=perf_prior)

    def schedule(self, event: TimelineEvent) -> None:
        """Script a mid-step fleet change at an absolute simulated time (see
        ``.clock``).  The event fires inside whichever future step's runtime
        window covers it; events past a step's last completion carry over."""
        self._timeline.append(event)

    def add_step_hook(self, hook: Callable[[int, float], object]) -> None:
        """Register a *step-start callback*: ``hook(step_idx, clock_s)`` is
        called as each step actually begins and returns an iterable of
        ``TimelineEvent``s (absolute times) to schedule.  This is how
        phase-anchored scenarios (``cluster.ScenarioSchedule``) see true
        step boundaries instead of plan-based estimates."""
        self._step_hooks.append(hook)

    # -- plan inspection -----------------------------------------------------
    def plan_preview(self) -> GrainPlan:
        """The allotment the next step would start from — exactly what the
        runtime will execute (used to verify that a restarted coordinator
        plans identically to a never-killed one)."""
        return self.runtime.plan(self.cfg.total_grains)

    # -- one training step ---------------------------------------------------
    def step(self, step_idx: int) -> dict:
        cfg = self.cfg
        # Client-side combine: token-weighted per-grain gradients, folded in
        # grain-id order as completions stream in.  Pure function of the
        # grain data — which pod ran a grain (and in what completion order)
        # cannot change the update.
        combine = _PrefixCombine(cfg.compress_grads, self.residuals,
                                 out=self._grads)
        for hook in self._step_hooks:
            self._timeline.extend(hook(step_idx, self.runtime.clock))
        events, self._timeline = tuple(self._timeline), []
        res = self.runtime.run(
            cfg.total_grains,
            executor=_GrainGradExecutor(self, step_idx, combine),
            timeline=events,
        )
        # Sync the fleet view with timeline kills/joins the runtime applied
        # (a rejoin replaces a previously-killed Pod of the same name).
        for name, worker in self.runtime.workers.items():
            self.pods[name] = worker
            worker.alive = True
        for name, pod in self.pods.items():
            if name not in self.runtime.workers:
                pod.alive = False

        grads = combine.grads(cfg.total_grains)
        self.residuals = combine.residuals
        tok_sum, loss_sum = combine.tok_sum, combine.loss_sum
        stats = self._apply_update(grads)

        ovh = cfg.overhead(cfg.total_grains)
        self.runtime.clock += ovh  # distribution overhead advances the clock
        step_start = res.end_s - res.makespan
        rec = {
            "step": step_idx,
            "loss": loss_sum / tok_sum,
            "tokens": tok_sum,
            "step_time": res.makespan + ovh,
            "plan": res.shares(),
            "quality": res.homogenization_quality(),
            "n_migrated": res.n_migrated,
            "n_steals": res.n_steals,
            "grad_norm": float(stats["grad_norm"]),
            # Per-pod execution footprint (step-relative), consumed by the
            # unified cluster.RunReport worker timelines.
            "worker_busy": dict(res.worker_busy),
            "worker_finish": {
                w: f - step_start for w, f in res.worker_finish.items()
            },
        }
        self.history.append(rec)
        if self.ckpt and (step_idx + 1) % cfg.ckpt_every == 0:
            self.ckpt.save(step_idx + 1, self.state, extras=self._extras())
        return rec

    def _extras(self) -> dict:
        return {
            "tracker": self.tracker.state_dict(),
            "clock": self.runtime.clock,
        }

    def run(self, n_steps: int) -> list[dict]:
        for s in range(self.start_step, n_steps):
            self.step(s)
        if self.ckpt:
            self.ckpt.wait()
        return self.history
