"""RunReport: the one result type every Cluster workload returns.

``ClusterSim`` returned ``JobResult``, the runtime returned ``RuntimeResult``,
``FleetServer`` returned ``FleetReport`` and ``HDPTrainer`` returned raw
history dicts — four shapes for one question: *did the fleet cross the
homogenization line, and how fast?*  A ``RunReport`` answers it uniformly:

  - ``phases``   one ``PhaseStats`` per job / training step / serve wave,
  - ``shares()`` grains executed per worker, aggregated across phases,
  - ``homogenization_quality()``  worst phase spread (1.0 = perfect),
  - ``predicted_speedup`` / ``measured_speedup``  the paper's Eq. 6 vs what
    the run actually measured against the best single worker,
  - ``worker_timelines``  per-worker busy time / last finish / grain count,
  - ``metrics`` / ``artifact``  workload-specific extras (loss history, the
    verified matmul product, the decoded requests, the live trainer).

The fleet and scenario ride along as their *canonical strings*, so a report
(or a benchmark JSON built from one) is always traceable to the exact
declarative inputs that produced it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

__all__ = ["WorkerTimeline", "PhaseStats", "RunReport"]


@dataclasses.dataclass(frozen=True)
class WorkerTimeline:
    """One worker's aggregate execution footprint across the run."""

    worker: str
    busy_s: float          # total simulated compute seconds
    finish_s: float        # last completion (relative to the run start)
    n_grains: int          # grains/requests completed


@dataclasses.dataclass(frozen=True)
class PhaseStats:
    """One phase: a sim job, a training step, or a serving wave."""

    index: int
    label: str                       # "job" | "step" | "wave"
    work: float                      # work units (rows, grains, tokens)
    sim_time_s: float                # makespan + attributed overhead
    quality: float                   # finish-time spread (1.0 = homogenized)
    n_migrated: int
    shares: Mapping[str, int]
    metrics: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class RunReport:
    """The unified result of ``Cluster.simulate`` / ``.train`` / ``.serve``."""

    kind: str                        # "simulate" | "train" | "serve"
    fleet: str                       # canonical FleetSpec string
    scenario: str                    # canonical Scenario string ("" = none)
    phases: tuple[PhaseStats, ...]
    work_done: float
    sim_time_s: float
    throughput: float                # work units per simulated second
    predicted_speedup: float         # paper Eq. 6 from the fleet's rate priors
    measured_speedup: float          # best-single-worker estimate / measured
    worker_timelines: Mapping[str, WorkerTimeline]
    metrics: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    artifact: Any = None
    coord: Any = None                # coord.CoordStats when dispatch is sharded
    latency: Any = None              # serve.LatencyStats for open-loop serves
    # Execution-backend provenance: "sim" (logical clock, modeled durations)
    # or "wallclock[<n>d]" (measured on <n> real devices) — keeps BENCH_*.json
    # entries from the two backends from being conflated.
    backend: str = "sim"
    # obs.Tracer rollup when the run was traced (``Cluster(trace=...)``):
    # ``{"counters": ..., "gauges": ..., "histograms": ..., "n_events": N}``
    # with deterministic key order.  None when tracing was off — the
    # default keeps untraced reports byte-identical to pre-obs builds.
    telemetry: Any = None

    # -- the uniform questions ----------------------------------------------
    def shares(self) -> dict[str, int]:
        """Grains/requests executed per worker, across all phases."""
        out: dict[str, int] = {}
        for p in self.phases:
            for w, n in p.shares.items():
                out[w] = out.get(w, 0) + n
        return out

    def homogenization_quality(self) -> float:
        """Worst per-phase finish-time spread (1.0 = every phase crossed the
        homogenization line).  Per-phase qualities already exclude workers
        that died during (or before) the phase — a dead worker's truncated
        span says nothing about how the survivors homogenized, and a worker
        dead for a whole phase must not drag the spread's denominator."""
        return max((p.quality for p in self.phases), default=1.0)

    @property
    def n_phases(self) -> int:
        return len(self.phases)

    @property
    def n_migrated(self) -> int:
        return sum(p.n_migrated for p in self.phases)

    def phase_times(self) -> list[float]:
        return [p.sim_time_s for p in self.phases]

    def summary(self) -> str:
        shares = " ".join(f"{w}:{n}" for w, n in sorted(self.shares().items()))
        s = (
            f"[{self.kind}] fleet={self.fleet} scenario={self.scenario or 'none'} "
            f"{self.n_phases} phase(s): {self.work_done:g} work in "
            f"{self.sim_time_s:.2f}s -> {self.throughput:.2f}/s, "
            f"quality={self.homogenization_quality():.2f}, "
            f"speedup {self.measured_speedup:.2f}x measured vs "
            f"{self.predicted_speedup:.2f}x predicted, shares[{shares}]"
        )
        if self.backend != "sim":
            s += f", backend={self.backend}"
        if self.coord is not None:
            s += f", coord[{self.coord.summary()}]"
        if self.latency is not None:
            s += (
                f", latency[p50_ttft={self.latency.p50_ttft_s:.3f}s "
                f"p99_ttft={self.latency.p99_ttft_s:.3f}s "
                f"shed={self.latency.shed_rate:.1%}]"
            )
        return s


def merge_worker_timelines(
    per_phase: list[tuple[Mapping[str, float], Mapping[str, float], Mapping[str, int]]],
) -> dict[str, WorkerTimeline]:
    """Fold per-phase (busy, finish, grain-count) maps into aggregate
    ``WorkerTimeline``s.  Callers pass finish times already offset to
    run-relative seconds (phase-relative finish + preceding phase spans);
    here we sum busy/counts and keep each worker's latest finish."""
    busy: dict[str, float] = {}
    finish: dict[str, float] = {}
    count: dict[str, int] = {}
    for busy_p, finish_p, count_p in per_phase:
        for w, b in busy_p.items():
            busy[w] = busy.get(w, 0.0) + b
        for w, f in finish_p.items():
            finish[w] = max(finish.get(w, 0.0), f)
        for w, n in count_p.items():
            count[w] = count.get(w, 0) + n
    names = set(busy) | set(finish) | set(count)
    return {
        w: WorkerTimeline(w, busy.get(w, 0.0), finish.get(w, 0.0), count.get(w, 0))
        for w in sorted(names)
    }
