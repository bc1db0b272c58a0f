"""HomogenizedScheduler: turns the perf vector into executable grain plans.

This is the production face of the paper's TDA server.  The schedulable work
unit is a *grain* (a fixed-shape microbatch for training, a request bundle for
serving, a block of matrix rows for the paper's own workload).  A *plan* maps
each worker to a contiguous range of grain ids — scope lengths, allotted by
``homogenization.scope_lengths``.

Production concerns handled here (beyond the paper):

  - hysteresis: replanning changes per-worker grain counts, and a new count
    means a new compiled XLA program for that worker; we replan only when the
    predicted step-time improvement exceeds ``replan_threshold``,
  - plan caching + determinism: plans are pure functions of
    (total_grains, worker-set, quantized perf vector).  Quantization floors
    each worker's relative perf at one quantum, so the schedulable dynamic
    range is 1/perf_quantum (20:1 by default) — workers slower than that are
    straggler-eviction candidates (PerformanceTracker.stragglers), not
    scheduling targets,
  - elasticity: workers can join/leave between steps; the next plan simply
    redistributes scope lengths over the survivors.
"""

from __future__ import annotations

import dataclasses

from .homogenization import (
    equal_split,
    finish_times,
    homogenization_quality,
    scope_lengths,
)
from .performance import PerformanceTracker

__all__ = ["GrainPlan", "HomogenizedScheduler", "should_replan"]


def should_replan(predicted_finish_s: list[float], threshold: float) -> bool:
    """Spread-based hysteresis gate used by the async runtime's mid-job
    re-homogenizer: migrating grains is worth a queue-shuffle only when the
    predicted finish-time spread exceeds ``threshold`` relative to the
    earliest finisher.  (``HomogenizedScheduler.plan`` keeps its own
    *improvement*-based criterion — replan when the candidate plan beats the
    current one by ``replan_threshold`` — because a step-level replan costs an
    XLA recompile, which a mere spread doesn't justify if no better plan
    exists.)"""
    if len(predicted_finish_s) < 2:
        return False
    lo, hi = min(predicted_finish_s), max(predicted_finish_s)
    return hi > lo * (1.0 + threshold) + 1e-12


@dataclasses.dataclass(frozen=True)
class GrainPlan:
    """Assignment of ``total_grains`` grains to workers (contiguous ranges)."""

    workers: tuple[str, ...]
    shares: tuple[int, ...]            # scope length per worker
    total_grains: int

    def __post_init__(self):
        if sum(self.shares) != self.total_grains:
            raise ValueError("shares must sum to total_grains")
        if len(self.workers) != len(self.shares):
            raise ValueError("workers/shares length mismatch")

    def range_for(self, worker: str) -> range:
        i = self.workers.index(worker)
        start = sum(self.shares[:i])
        return range(start, start + self.shares[i])

    def share_for(self, worker: str) -> int:
        return self.shares[self.workers.index(worker)]

    @property
    def weights(self) -> tuple[float, ...]:
        """Combine weights for the client-side merge (token-weighted grad
        all-reduce): proportional to grains actually computed."""
        if self.total_grains == 0:
            return tuple(0.0 for _ in self.shares)
        return tuple(s / self.total_grains for s in self.shares)


class HomogenizedScheduler:
    def __init__(
        self,
        tracker: PerformanceTracker,
        total_grains: int,
        replan_threshold: float = 0.05,
        perf_quantum: float = 0.05,
        homogenize: bool = True,
    ):
        """``homogenize=False`` degrades to the paper's equal-split baseline
        (the 'heterogeneous behavior' curves of Fig. 3/6)."""
        if total_grains <= 0:
            raise ValueError("total_grains must be > 0")
        self.tracker = tracker
        self.total_grains = total_grains
        self.replan_threshold = replan_threshold
        self.perf_quantum = perf_quantum
        self.homogenize = homogenize
        self._current: GrainPlan | None = None
        self._cache: dict[tuple, GrainPlan] = {}
        self.n_replans = 0

    # -- internals ----------------------------------------------------------
    def _quantize(self, perfs: dict[str, float]) -> tuple[tuple[str, float], ...]:
        """Quantize relative perfs so jitter below ``perf_quantum`` cannot
        thrash the plan cache."""
        mx = max(perfs.values())
        q = self.perf_quantum
        return tuple(
            (w, max(q, round(p / mx / q) * q)) for w, p in sorted(perfs.items())
        )

    def _plan_for(self, qperfs: tuple[tuple[str, float], ...]) -> GrainPlan:
        key = (self.total_grains, self.homogenize, qperfs)
        plan = self._cache.get(key)
        if plan is None:
            workers = tuple(w for w, _ in qperfs)
            ps = [p for _, p in qperfs]
            shares = (
                scope_lengths(self.total_grains, ps)
                if self.homogenize
                else equal_split(self.total_grains, len(ps))
            )
            plan = GrainPlan(workers, tuple(shares), self.total_grains)
            self._cache[key] = plan
        return plan

    def _predicted_step_time(self, plan: GrainPlan, perfs: dict[str, float]) -> float:
        ps = [perfs[w] for w in plan.workers]
        return max(finish_times(plan.shares, ps)) if plan.workers else 0.0

    # -- public -------------------------------------------------------------
    def plan(self, now_s: float | None = None, force: bool = False) -> GrainPlan:
        """Return the plan for the next step, replanning only past hysteresis."""
        perfs = self.tracker.perf_vector(now_s)
        if not perfs:
            raise RuntimeError("no live workers to schedule")
        candidate = self._plan_for(self._quantize(perfs))
        if self._current is None or force:
            self._current, self.n_replans = candidate, self.n_replans + 1
            return self._current
        if set(self._current.workers) != set(perfs):
            # Elastic change (join/leave/death) always forces a replan.
            self._current, self.n_replans = candidate, self.n_replans + 1
            return self._current
        cur_t = self._predicted_step_time(self._current, perfs)
        new_t = self._predicted_step_time(candidate, perfs)
        if new_t < cur_t * (1 - self.replan_threshold):
            self._current, self.n_replans = candidate, self.n_replans + 1
        return self._current

    def quality(self, now_s: float | None = None) -> float:
        """Homogenization quality of the current plan (1.0 = perfect)."""
        if self._current is None:
            return 1.0
        perfs = self.tracker.perf_vector(now_s)
        ps = [perfs.get(w, 1e-9) for w in self._current.workers]
        return homogenization_quality(self._current.shares, ps)
