"""Discrete-event simulator of a heterogeneous cluster (paper §3 testbed).

The paper's testbed is 9 Intel machines (P-II/III/IV, 64-128 MB RAM, 100 Mbps
Ethernet) multiplying square matrices of size 200..1000.  This container has
one CPU, so we reproduce the *timing* behaviour with a simulator whose cost
model is exactly the paper's (Eqs. 1-9):

  - workload: size-n matmul, granulized by rows of the first matrix
    (L = n rows; one row costs n^2 multiply-adds),
  - per-worker compute time: share_i * unit_cost / P_i (+ optional jitter,
    modelling the paper's "runtime performance varies during operation"),
  - distribution overhead: the paper's linear model O(L) = L / M (M = 20 for
    their Ethernet; configurable),
  - job time: max_i compute_i + O(L); speedup vs the standalone reference.

Numerical *correctness* of the distributed matmul itself is exercised by the
real execution path in ``core/tda.py`` (which computes actual matrices and
compares against the single-machine product); this module is the timing
oracle used by the Fig 3-6 benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .homogenization import OverheadModel, equal_split, scope_lengths
from .performance import PerformanceTracker

__all__ = [
    "Machine",
    "JobResult",
    "ClusterSim",
    "PAPER_MACHINES",
    "REF_SIZE",
]

# A 9-machine heterogeneous profile shaped like the paper's: five mid-to-fast
# machines, with the 6th and 9th markedly slow (the paper observes speedup
# degradation exactly when those two join under equal allotment).
PAPER_MACHINES: tuple[float, ...] = (1.0, 0.9, 0.85, 0.8, 0.75, 0.35, 0.7, 0.6, 0.3)

# Reference matrix size: unit work = one result row at size 800.
REF_SIZE = 800


@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    perf: float  # P_i: result rows (at REF_SIZE) per simulated second


@dataclasses.dataclass(frozen=True)
class JobResult:
    """One simulated job.  As a *user-facing* result type this is superseded
    by ``repro.cluster.RunReport`` (``Cluster.simulate`` wraps the runtime's
    records); it remains the sim tier's internal/plot-level record."""

    n: int
    n_workers: int
    homogenized: bool
    shares: tuple[int, ...]
    compute_time: float       # max over workers (the dark bars of Fig 3)
    overhead: float           # O(L) (the grey bars of Fig 3)
    total_time: float
    standalone_time: float

    @property
    def speedup(self) -> float:
        return self.standalone_time / self.total_time


class ClusterSim:
    """Simulated heterogeneous LAN running granulized matmul jobs."""

    def __init__(
        self,
        perfs: Sequence[float] = PAPER_MACHINES,
        overhead: OverheadModel | None = None,
        jitter: float = 0.0,
        seed: int = 0,
        p_standalone: float | None = None,
    ):
        self.machines = [Machine(f"sp{i}", float(p)) for i, p in enumerate(perfs)]
        self.overhead = overhead or OverheadModel(m=20.0)
        self.jitter = jitter
        self.rng = np.random.default_rng(seed)
        # Paper: speedup is measured against a standalone machine; we take the
        # fastest machine as the standalone reference unless told otherwise.
        self.p_standalone = (
            max(m.perf for m in self.machines) if p_standalone is None else p_standalone
        )

    # ------------------------------------------------------------------
    @staticmethod
    def unit_cost(n: int) -> float:
        """Simulated seconds per result row for a P=1 machine: rows cost n^2
        madds, normalized so one row at REF_SIZE costs 1.0."""
        return (n / REF_SIZE) ** 2

    def standalone_time(self, n: int) -> float:
        return n * self.unit_cost(n) / self.p_standalone

    def _worker_time(self, share: int, perf: float, n: int) -> float:
        t = share * self.unit_cost(n) / perf
        if self.jitter:
            t *= float(1.0 + self.jitter * self.rng.standard_normal())
        return max(t, 0.0)

    # ------------------------------------------------------------------
    def run_job(
        self,
        n: int,
        n_workers: int | None = None,
        homogenize: bool = True,
        perf_estimates: Sequence[float] | None = None,
    ) -> JobResult:
        """Run one size-n matmul job over the first ``n_workers`` machines.

        ``perf_estimates`` lets a caller allot from *estimated* performance
        (e.g. a PerformanceTracker's view) while execution uses true perfs —
        that gap is what the adaptive experiments measure.
        """
        workers = self.machines[: n_workers or len(self.machines)]
        true_p = [m.perf for m in workers]
        alloc_p = list(perf_estimates) if perf_estimates is not None else true_p
        if len(alloc_p) != len(workers):
            raise ValueError("perf_estimates length mismatch")
        shares = (
            scope_lengths(n, alloc_p) if homogenize else equal_split(n, len(workers))
        )
        times = [
            self._worker_time(s, p, n) for s, p in zip(shares, true_p, strict=True)
        ]
        compute = max(times)
        ovh = self.overhead(n)
        return JobResult(
            n=n,
            n_workers=len(workers),
            homogenized=homogenize,
            shares=tuple(shares),
            compute_time=compute,
            overhead=ovh,
            total_time=compute + ovh,
            standalone_time=self.standalone_time(n),
        )

    # ------------------------------------------------------------------
    def speedup_curve(
        self, n: int, homogenize: bool, max_workers: int | None = None
    ) -> list[float]:
        """Speedup vs number of service-providers (Fig 3c / Fig 6)."""
        top = max_workers or len(self.machines)
        return [
            self.run_job(n, k, homogenize=homogenize).speedup
            for k in range(1, top + 1)
        ]

    def run_adaptive(
        self,
        n: int,
        n_jobs: int,
        tracker: PerformanceTracker | None = None,
        adaptive: bool = True,
        timelines: dict[int, tuple] | None = None,
    ) -> list[JobResult]:
        """Closed-loop homogenization, now a thin client of the async runtime
        (``core/runtime.py``): each size-n job streams row-grains through the
        event loop, every grain completion is a heartbeat into the tracker,
        and the runtime re-homogenizes/steals mid-job.  Starting from an
        all-equal prior, speedup converges to the oracle-perf value.

        ``adaptive=False`` freezes each job to its initial plan (the static
        one-shot baseline the paper — and our regression tests — compare
        against).  ``timelines`` optionally maps job index -> TimelineEvents
        (times relative to that job's start) for mid-job perf shifts."""
        from .runtime import AsyncRuntime, SimWorker  # runtime is layered above

        tracker = tracker or PerformanceTracker(alpha=0.5)
        # SimWorker is the mutable runtime-facing view: timeline events shift
        # its perf without touching the frozen Machine spec.
        workers = [SimWorker(m.name, m.perf) for m in self.machines]
        rt = AsyncRuntime(
            workers, tracker=tracker,
            rehomogenize=adaptive, steal=adaptive, replan_threshold=0.02,
        )
        unit = self.unit_cost(n)

        def duration(worker, cost, now_s):
            return self._worker_time(cost / unit, worker.perf, n)

        results: list[JobResult] = []
        for job in range(n_jobs):
            run = rt.run(n, grain_cost=unit, duration_fn=duration,
                         timeline=(timelines or {}).get(job, ()),
                         timeline_relative=True)
            counts = run.shares()
            ovh = self.overhead(n)
            results.append(JobResult(
                n=n,
                n_workers=len(self.machines),
                homogenized=True,
                shares=tuple(counts.get(m.name, 0) for m in self.machines),
                compute_time=run.makespan,
                overhead=ovh,
                total_time=run.makespan + ovh,
                standalone_time=self.standalone_time(n),
            ))
            rt.clock += ovh  # distribution overhead advances the fleet clock
        return results
