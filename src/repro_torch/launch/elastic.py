"""Elastic fleet management: re-mesh plans after pod loss/join.

Copy of ``repro/launch/elastic.py`` (free of JAX there too), on the port's
``core`` and ``checkpoint``.  The reference's description follows.

At 1000+ node scale, pod failures are routine.  The recovery path here is the
TDA-shaped one the rest of the framework already implements:

  1. heartbeats stop → PerformanceTracker.sweep declares the pod dead,
  2. ElasticFleet computes the new *outer* worker set and a RemeshPlan:
     which mesh each surviving pod runs (inner SPMD meshes are per-pod and
     unchanged — a dead pod never forces a global re-shard), how the grain
     scope-lengths redistribute, and which checkpoint step to resume from,
  3. survivors reload the last complete checkpoint (grain addressing is a
     pure function of (step, plan), so no data-redistribution protocol) and
     training continues.

The inner-mesh story for a *partial* pod loss (some chips of a slice) is
re-slicing: the pod re-enters with a smaller inner mesh and a proportionally
smaller heartbeat perf — homogenization then allots it less work, no special
case needed.  That degradation path is exactly the paper's mechanism.
"""

from __future__ import annotations

import dataclasses

from ..core.homogenization import scope_lengths
from ..core.performance import PerformanceTracker, PerfReport
from ..core.runtime import AsyncRuntime, RuntimeResult, SimWorker
from ..core.scheduler import GrainPlan

__all__ = ["PodSpec", "RemeshPlan", "ElasticFleet"]


@dataclasses.dataclass(frozen=True)
class PodSpec:
    name: str
    n_chips: int                # inner mesh size (e.g. 256)
    mesh_shape: tuple[int, int]  # inner (data, model)

    def __post_init__(self):
        d, m = self.mesh_shape
        if d * m != self.n_chips:
            raise ValueError(f"{self.name}: mesh {self.mesh_shape} != {self.n_chips} chips")


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    survivors: tuple[str, ...]
    grain_plan: GrainPlan
    resume_step: int
    lost: tuple[str, ...]

    @property
    def capacity_fraction(self) -> float:
        return len(self.survivors) / max(len(self.survivors) + len(self.lost), 1)


class ElasticFleet:
    def __init__(self, pods: list[PodSpec], tracker: PerformanceTracker,
                 total_grains: int):
        self.pods = {p.name: p for p in pods}
        self.tracker = tracker
        self.total_grains = total_grains
        self._lost: set[str] = set()

    def alive(self) -> list[str]:
        return [n for n in self.pods if n not in self._lost]

    def handle_failures(self, now_s: float, last_ckpt_step: int) -> RemeshPlan | None:
        """Sweep heartbeats; if pods died, produce the recovery plan."""
        died = self.tracker.sweep(now_s)
        died = [d for d in died if d in self.pods and d not in self._lost]
        if not died:
            return None
        self._lost.update(died)
        return self._plan(last_ckpt_step)

    def handle_join(self, pod: PodSpec, perf_prior: float, now_s: float,
                    last_ckpt_step: int) -> RemeshPlan:
        """A (repaired or new) pod joins; it starts with a prior perf and the
        tracker refines it from real heartbeats.  This is the *explicit*
        rejoin path — a mere late heartbeat from a swept-dead pod is rejected
        by the tracker and cannot resurrect it."""
        self.pods[pod.name] = pod
        self._lost.discard(pod.name)
        self.tracker.rejoin(pod.name, perf_prior, now_s)
        return self._plan(last_ckpt_step)

    @classmethod
    def from_checkpoint(
        cls, pods: list[PodSpec], ckpt_dir: str, total_grains: int,
        step: int | None = None, **tracker_kw,
    ) -> "ElasticFleet":
        """Rebuild the coordinator's fleet view from a checkpoint's sidecar
        extras: the tracker resumes from *learned* perfs instead of neutral
        priors.  Checkpointed workers absent from ``pods`` are marked dead;
        pods the checkpoint never saw get a neutral prior.  Explicit
        ``tracker_kw`` (alpha, dead_after_s, ...) win over the checkpointed
        tracker config — only the EMA table itself is taken from the
        checkpoint."""
        from ..checkpoint.checkpoint import read_extras

        tracker = PerformanceTracker(**tracker_kw)
        extras = read_extras(ckpt_dir, step)
        now_s = 0.0
        if extras is not None:
            if "tracker" in extras:
                tracker.load_state_dict(extras["tracker"])
                for key, val in tracker_kw.items():
                    setattr(tracker, key, val)   # caller tuning wins
            now_s = float(extras.get("clock", 0.0))
        names = {p.name for p in pods}
        for name in tracker.workers():
            if name not in names:
                tracker.mark_dead(name)
        for p in pods:
            # Passing a pod in ``pods`` is the explicit (re)join: dead-in-
            # checkpoint or never-seen pods enter with a neutral prior.
            if p.name not in tracker.workers():
                tracker.rejoin(p.name, 1.0, now_s)
        return cls(pods, tracker, total_grains)

    def rehearse(self, plan: RemeshPlan) -> RuntimeResult:
        """Dry-run a remesh plan through the async runtime before committing:
        survivors execute the redistributed grains in simulation (perfs = the
        tracker's learned view), predicting the post-recovery makespan and
        homogenization quality.  Uses a throwaway tracker so rehearsal
        heartbeats never pollute the live one."""
        perfs = self.tracker.perf_vector()
        shadow = PerformanceTracker(alpha=0.5)
        workers = []
        for name in plan.survivors:
            p = max(perfs.get(name, 1e-9), 1e-9)
            workers.append(SimWorker(name, p))
            shadow.observe(PerfReport(name, p, 1.0, 0.0))
        rt = AsyncRuntime(workers, tracker=shadow)
        return rt.run(plan.grain_plan.total_grains,
                      initial_plan=plan.grain_plan)

    def _plan(self, resume_step: int) -> RemeshPlan:
        alive = self.alive()
        if not alive:
            raise RuntimeError("all pods lost")
        perfs = self.tracker.perf_vector()
        ps = [max(perfs.get(n, 1e-9), 1e-9) for n in alive]
        shares = scope_lengths(self.total_grains, ps)
        return RemeshPlan(
            survivors=tuple(alive),
            grain_plan=GrainPlan(tuple(alive), tuple(shares), self.total_grains),
            resume_step=resume_step,
            lost=tuple(sorted(self._lost)),
        )
