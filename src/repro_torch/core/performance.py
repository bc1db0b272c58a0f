"""Performance tracking: the paper's "background process" + homogenized performance.

The TDA server maintains tables of worker performance; each service-provider
reports its current load/throughput "after certain time interval".  The server
folds the reports into a single *homogenized performance* number per worker,
which the allotment (scope-length) computation consumes.

We realize the fold as an exponential moving average over observed throughput
(work-units per second), with:

  - staleness decay: a worker that stops reporting is progressively distrusted,
  - straggler flagging: perf below ``straggler_fraction`` of the fleet median,
  - liveness: workers missing ``dead_after`` heartbeats are declared dead
    (feeds the elastic replan path).  Death is sticky: a late heartbeat from a
    dead worker is *rejected*, not folded in — only the explicit ``rejoin``
    API brings a worker back (with a fresh prior, since its old EMA describes
    a machine state that no longer exists),
  - persistence: ``state_dict``/``load_state_dict`` round-trip the whole table
    through JSON, so checkpoints carry learned perfs across coordinator
    restarts.

Pure Python control-plane code (runs on the coordinator host, never traced).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

__all__ = ["PerfReport", "WorkerState", "PerformanceTracker"]


@dataclasses.dataclass(frozen=True)
class PerfReport:
    """One heartbeat from a service-provider."""

    worker: str
    work_done: float          # work units (grains, tokens, matrix rows...)
    elapsed_s: float          # wall-clock seconds for that work
    time_s: float             # report timestamp (simulated or real clock)

    @property
    def throughput(self) -> float:
        if self.elapsed_s <= 0:
            raise ValueError("elapsed_s must be > 0")
        return self.work_done / self.elapsed_s


@dataclasses.dataclass
class WorkerState:
    perf: float               # homogenized performance (EMA of throughput)
    last_report_s: float
    n_reports: int = 0
    alive: bool = True


class PerformanceTracker:
    """EMA tracker producing the paper's homogenized-performance vector."""

    def __init__(
        self,
        alpha: float = 0.3,
        staleness_half_life_s: float = 60.0,
        dead_after_s: float = 300.0,
        straggler_fraction: float = 0.5,
    ):
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self.staleness_half_life_s = staleness_half_life_s
        self.dead_after_s = dead_after_s
        self.straggler_fraction = straggler_fraction
        self._workers: dict[str, WorkerState] = {}
        self.n_rejected = 0   # heartbeats dropped because the worker was dead

    # -- ingest ------------------------------------------------------------
    def observe(self, report: PerfReport) -> None:
        tput = report.throughput
        st = self._workers.get(report.worker)
        if st is None:
            self._workers[report.worker] = WorkerState(
                perf=tput, last_report_s=report.time_s, n_reports=1
            )
            return
        if not st.alive:
            # Kills persist: a stale/late heartbeat must not resurrect a dead
            # worker (the scheduler would allot grains to a ghost).  rejoin()
            # is the explicit path back into the fleet.
            self.n_rejected += 1
            return
        st.perf = self.alpha * tput + (1 - self.alpha) * st.perf
        st.last_report_s = max(st.last_report_s, report.time_s)
        st.n_reports += 1

    def observe_many(self, reports: Iterable[PerfReport]) -> None:
        for r in reports:
            self.observe(r)

    # -- liveness ----------------------------------------------------------
    def mark_dead(self, worker: str) -> None:
        if worker in self._workers:
            self._workers[worker].alive = False

    def rejoin(self, worker: str, perf_prior: float = 1.0,
               now_s: float = 0.0) -> None:
        """Explicitly (re)admit a worker with a fresh prior.  The only way
        back after mark_dead/sweep — the old EMA is discarded because it
        describes the pre-failure machine."""
        if perf_prior <= 0:
            raise ValueError("perf_prior must be > 0")
        self._workers[worker] = WorkerState(
            perf=float(perf_prior), last_report_s=now_s, n_reports=1
        )

    def sweep(self, now_s: float) -> list[str]:
        """Declare workers dead after ``dead_after_s`` without a heartbeat.
        Returns the newly-dead worker ids (elastic replan trigger)."""
        died = []
        for name, st in self._workers.items():
            if st.alive and now_s - st.last_report_s > self.dead_after_s:
                st.alive = False
                died.append(name)
        return died

    # -- query -------------------------------------------------------------
    def workers(self, alive_only: bool = True) -> list[str]:
        return sorted(
            n for n, s in self._workers.items() if s.alive or not alive_only
        )

    def perf(self, worker: str, now_s: float | None = None) -> float:
        st = self._workers[worker]
        p = st.perf
        if now_s is not None and now_s > st.last_report_s:
            # Staleness decay: halve trust every half-life without a report.
            age = now_s - st.last_report_s
            p *= 0.5 ** (age / self.staleness_half_life_s)
        return p

    def perf_map(self, workers: Iterable[str], now_s: float | None = None,
                 floor: float = 0.0) -> dict[str, float]:
        """Bulk ``perf`` lookups in one pass — the runtime's per-event ETA
        hot path.  Unknown workers get ``floor``; known perfs are floored at
        ``floor`` after staleness decay.  Bitwise-identical to
        ``max(self.perf(w, now_s), floor)`` per worker (with KeyError mapping
        to ``floor``)."""
        out: dict[str, float] = {}
        states = self._workers
        hl = self.staleness_half_life_s
        for w in workers:
            st = states.get(w)
            if st is None:
                out[w] = floor
                continue
            p = st.perf
            if now_s is not None and now_s > st.last_report_s:
                p *= 0.5 ** ((now_s - st.last_report_s) / hl)
            out[w] = p if p >= floor else floor
        return out

    def last_report_s(self, worker: str) -> float | None:
        """When the worker last heartbeat (None if never seen) — the truth
        stamp gossiped perf views are measured against."""
        st = self._workers.get(worker)
        return None if st is None else st.last_report_s

    def n_reports(self, worker: str) -> int:
        """How many heartbeats have been folded for ``worker`` (0 if never
        seen).  A rejoin prior counts as one; anything above that is a
        *measured* observation."""
        st = self._workers.get(worker)
        return 0 if st is None else st.n_reports

    def perf_vector(self, now_s: float | None = None) -> dict[str, float]:
        return {w: self.perf(w, now_s) for w in self.workers()}

    def stragglers(self, now_s: float | None = None) -> list[str]:
        pv = self.perf_vector(now_s)
        if len(pv) < 2:
            return []
        med = float(np.median(list(pv.values())))
        return sorted(w for w, p in pv.items() if p < self.straggler_fraction * med)

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable snapshot (config + per-worker EMA table).
        Python floats round-trip exactly through json, so a restored tracker
        plans bitwise-identically to the one that was checkpointed."""
        return {
            "config": {
                "alpha": self.alpha,
                "staleness_half_life_s": self.staleness_half_life_s,
                "dead_after_s": self.dead_after_s,
                "straggler_fraction": self.straggler_fraction,
            },
            "workers": {
                name: {
                    "perf": st.perf,
                    "last_report_s": st.last_report_s,
                    "n_reports": st.n_reports,
                    "alive": st.alive,
                }
                for name, st in self._workers.items()
            },
        }

    def load_state_dict(self, state: dict) -> None:
        cfg = state.get("config", {})
        for key in ("alpha", "staleness_half_life_s", "dead_after_s",
                    "straggler_fraction"):
            if key in cfg:
                setattr(self, key, float(cfg[key]))
        self._workers = {
            name: WorkerState(
                perf=float(st["perf"]),
                last_report_s=float(st["last_report_s"]),
                n_reports=int(st.get("n_reports", 1)),
                alive=bool(st.get("alive", True)),
            )
            for name, st in state.get("workers", {}).items()
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "PerformanceTracker":
        t = cls()
        t.load_state_dict(state)
        return t
