"""Event-driven async TDA runtime: mid-job re-homogenization + work-stealing.

The paper's TDA plans a job *once* from the homogenized performance vector.
That is exactly the failure mode dynamic-load-balancing surveys show static
schemes losing to: a service-provider that slows down (or dies, or joins)
mid-job breaks the homogenization-line invariant, and the job finishes at the
straggler's pace.  This module closes the loop at *grain* granularity.

Substrate
---------
A discrete event loop over a logical clock:

  - every worker owns a queue of unstarted grains plus at most one in-flight
    grain (a grain is the schedulable work unit: a matrix row, a request, a
    microbatch),
  - each grain completion is an event: the observed grain latency is fed to
    the ``PerformanceTracker`` as a heartbeat (the paper's background
    process), so the homogenized perf vector tracks *current* speed,
  - after each completion the runtime re-homogenizes: when predicted
    worker finish times (ETAs) diverge past the hysteresis threshold, it
    migrates *unstarted* grains from the latest-finishing queue to the
    earliest-finishing one (in-flight grains never move, so no grain is ever
    executed twice),
  - a worker whose queue drains steals the tail of the worst-ETA queue,
    split proportionally to homogenized perf (``scope_lengths`` over
    {victim, thief} — stealing *is* re-homogenization of the remainder),
  - scripted ``TimelineEvent``s inject mid-job perf shifts, deaths and
    joins; a dead worker's in-flight grain is re-queued (it never completed,
    so re-execution is safe and exactly-once per *completed* grain holds).

What a grain *is* is the ``GrainExecutor`` seam: one object answers the three
questions the loop asks — what a grain costs, how long a given worker needs
for it, and what real compute happens at completion (never for aborted
grains), so values are exact while timing comes from the cost model.  Sim
row-blocks, serve request bundles and HDP training microbatches are three
executors of the same loop.  ``TDAServer``/``ThinClient``,
``HomogenizedDispatcher``, ``ClusterSim``, ``HDPTrainer`` and ``ElasticFleet``
are all thin clients.

*Who decides* is the ``DispatchAuthority`` seam: heartbeat ingest, mid-job
re-homogenization, stealing and kill-heir choice route through one authority
object.  The default ``SingleCoordinator`` is the paper's single TDA (one
global perf view, fleet-wide rebalancing).  ``repro.coord.ShardedCoordinator``
partitions the same decisions across K coordinator replicas with gossiped
perf views — the event loop itself never changes, only who answers it.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import os
from collections import deque
from time import perf_counter as _perf_counter
from typing import Any, Callable

from .homogenization import scope_lengths
from .performance import PerformanceTracker, PerfReport
from .scheduler import GrainPlan, HomogenizedScheduler, should_replan

__all__ = [
    "SimWorker",
    "TimelineEvent",
    "GrainRecord",
    "GrainExecutor",
    "CallableGrainExecutor",
    "ArrivalSource",
    "RuntimeResult",
    "AsyncRuntime",
    "JobContext",
    "DispatchAuthority",
    "SingleCoordinator",
    "ExecutionBackend",
    "SimBackend",
]

_EPS = 1e-12

_COORD_KINDS = ("ckill", "partition", "heal")
_WORKLOAD_KINDS = ("arrive", "mix")


class _CostedQueue(deque):
    """A grain queue that maintains its total cost incrementally: every
    mutation folds the grain's cost in or out at O(1), so queue-drain ETAs
    never re-sum the queue.  Used for non-uniform cost models (uniform-cost
    queues read ``len(q) * uniform``, which is exact without tracking).

    ``cost_of`` must be pure (same grain -> same cost) — the invariant the
    whole ETA machinery already assumes.  The running total equals a fresh
    in-order sum bitwise whenever per-grain costs add exactly (integers and
    dyadic rationals — every in-repo cost model); arbitrary float costs can
    drift by ulps from a fresh sum, which ``AsyncRuntime(eta_mode=
    'recompute')`` exists to measure."""

    __slots__ = ("cost", "cost_of")

    def __init__(self, cost_of: Callable[[int], float], grains=()):
        super().__init__()
        self.cost = 0.0
        self.cost_of = cost_of
        if grains:
            self.extend(grains)

    def append(self, g):
        deque.append(self, g)
        self.cost += self.cost_of(g)

    def appendleft(self, g):
        deque.appendleft(self, g)
        self.cost += self.cost_of(g)

    def extend(self, grains):
        for g in grains:
            self.append(g)

    def pop(self):
        g = deque.pop(self)
        self.cost -= self.cost_of(g)
        return g

    def popleft(self):
        g = deque.popleft(self)
        self.cost -= self.cost_of(g)
        return g


@dataclasses.dataclass
class JobContext:
    """The per-job state a ``DispatchAuthority`` decides over: the live
    queues, the death set, the cost model and the ETA machinery.  ``eta_with``
    lets an authority compute finish-time predictions under *its own* perf
    view (a coordinator shard's gossiped table) instead of the runtime's
    global tracker estimate; ``etas_under`` is its bulk form — one tight pass
    over many workers given a precomputed perf map (the per-event hot path).
    ``live`` is the runtime-maintained alive-worker list (insertion order,
    updated on kill/join) — read it, never mutate it."""

    queues: dict[str, deque]
    dead: set[str]
    res: "RuntimeResult"
    cost_of: Callable[[int], float]
    est_perf: Callable[[str], float]                 # global tracker estimate
    eta: Callable[[str], float]                      # eta under est_perf
    eta_with: Callable[[str, Callable[[str], float]], float]
    clock: Callable[[], float]
    n_grains: int = 0
    live: list[str] = dataclasses.field(default_factory=list)
    # Bulk ETAs: etas_under(workers, perf_map) -> {worker: eta}; perf values
    # must already be floored at _EPS (perf_map/authority maps are).
    etas_under: Callable[[list[str], dict[str, float]], dict[str, float]] = None
    # Bulk global-tracker perf estimates, floored at _EPS (== est_perf per
    # worker, computed in one pass).
    perf_map: Callable[[list[str]], dict[str, float]] = None
    # Fused decay+ETA over a gossip view: etas_under_view(workers,
    # entries.get, half_life) -> (est, etas), bitwise-identical to
    # perf_floor_map followed by etas_under but in one lazy pass (est is a
    # memoized per-worker decayed-perf accessor).
    etas_under_view: Callable = None
    new_queue: Callable[[], deque] = deque
    # Runtime-internal: workers that may need a (re)start (see run()).
    idle: set = dataclasses.field(default_factory=set)
    # Pooled executors: worker name -> pool name (None = unpooled job).
    # Rebalance/steal/heir decisions partition by pool when set.
    pool_of: Callable[[str], str | None] | None = None


class DispatchAuthority:
    """Seam between the event loop and the coordination plane.

    The loop asks the authority five questions: where does a heartbeat go
    (``observe``), which queues re-homogenize together (``rebalance``), where
    does an idle worker steal from (``steal_for``), who inherits a dead
    worker's orphans (``heir_for``), and what does a coordinator-plane
    timeline event mean (``apply_coord_event``).  The default answers below
    are the single-TDA semantics the repo always had; a sharded authority
    re-answers them per coordinator replica."""

    runtime: "AsyncRuntime"

    def bind(self, runtime: "AsyncRuntime") -> None:
        self.runtime = runtime

    # -- lifecycle -----------------------------------------------------------
    def begin_job(self, ctx: JobContext) -> None:
        pass

    def end_job(self, ctx: JobContext) -> None:
        pass

    def advance(self, now_s: float, ctx: JobContext) -> None:
        """Lazily run any time-based coordination work (gossip rounds) due at
        or before ``now_s`` — called before every event is processed."""

    # -- perf view -----------------------------------------------------------
    def observe(self, report: PerfReport, ctx: JobContext) -> None:
        self.runtime.tracker.observe(report)

    # -- membership ----------------------------------------------------------
    def on_join(self, name: str, ctx: JobContext | None = None) -> None:
        pass

    def on_worker_kill(self, name: str, ctx: JobContext | None = None) -> None:
        pass

    def heir_for(self, name: str, live: list[str], ctx: JobContext) -> str:
        """Which live worker adopts a dead worker's orphaned grains."""
        return min(live, key=ctx.eta)

    # -- decisions -----------------------------------------------------------
    def rebalance(self, ctx: JobContext, worker: str | None = None) -> None:
        """Fleet-wide hysteresis-gated migration (the single-TDA default).
        ``worker`` hints which worker's completion triggered the call so a
        sharded authority can rebalance only the affected shard."""
        live = ctx.live
        if len(live) < 2:
            return
        if ctx.pool_of is not None:
            # Pooled job (disaggregated roles): each pool homogenizes its own
            # queues — grains never cross pools, so neither do migrations.
            groups: dict[Any, list[str]] = {}
            for w in live:
                groups.setdefault(ctx.pool_of(w), []).append(w)
            for group in groups.values():
                self._rebalance_group(group, ctx)
            return
        self._rebalance_group(live, ctx)

    def _rebalance_group(self, live: list[str], ctx: JobContext) -> None:
        rt = self.runtime
        if len(live) < 2:
            return
        if rt.eta_mode == "recompute":
            # Reference path: per-worker closure chain, recomputed from
            # scratch (the pre-fast-path implementation, kept for bitwise
            # A/B — see AsyncRuntime eta_mode).
            rt._rebalance_reference(
                live, ctx.queues, ctx.eta, ctx.cost_of, ctx.est_perf,
                ctx.res)
            return
        pmap = ctx.perf_map(live)
        etas = ctx.etas_under(live, pmap)
        rt._rebalance(live, ctx.queues, ctx.cost_of, pmap.__getitem__,
                      ctx.res, etas)

    def steal_for(self, thief: str, ctx: JobContext) -> int:
        queues = ctx.queues
        if ctx.pool_of is not None:
            pool = ctx.pool_of(thief)
            queues = {w: q for w, q in queues.items()
                      if ctx.pool_of(w) == pool}
        return self.runtime._steal_into(
            thief, queues, ctx.eta, ctx.est_perf, ctx.res
        )

    # -- coordinator-plane events -------------------------------------------
    def apply_coord_event(self, ev: "TimelineEvent", now_s: float,
                          ctx: JobContext) -> None:
        raise ValueError(
            f"timeline event {ev.kind!r} targets the coordination plane, but "
            "this runtime has a single coordinator; shard it first "
            "(FleetSpec '/cK' suffix / repro.coord.ShardedCoordinator)"
        )

    def count_event(self, worker: str | None, kind: str,
                    ctx: JobContext) -> None:
        """Event accounting (per-shard dispatch load); free for the default."""

    def stats(self):
        """Coordination-plane stats for reports (None = single coordinator)."""
        return None


class SingleCoordinator(DispatchAuthority):
    """The paper's single dispatch authority, stated explicitly."""


class ExecutionBackend:
    """Seam between the event loop and *how a grain's work actually runs*.

    The ``GrainExecutor`` answers what a grain is (cost model, real compute);
    the backend answers where its duration comes from.  The default
    ``SimBackend`` is the logical-clock simulator the repo always had: the
    loop asks ``executor.duration_s`` for a modeled time and the clock jumps
    there.  ``repro.core.wallclock.WallclockBackend`` instead launches a real
    async device computation per grain and *measures* it — the completion
    event's duration, the heartbeat fed to the tracker, and
    ``RuntimeResult.worker_busy`` all become wall-clock observations.

    Per-grain protocol (modeled path):

      launch(ex, w, g, cost, t)     start the grain's real work; returns an
                                    opaque handle carried on the in-flight
                                    record (None for pure-sim backends),
      duration_s(ex, w, g, ...)     seconds to schedule the completion event
                                    at (modeled, measured, or an estimate
                                    settled later — see ``settle``),
      settle(ex, w, g, h, event_d)  called at the completion event with the
                                    event-clock duration; returns the duration
                                    to *record* (a measuring backend blocks on
                                    the handle here and returns wall time),
      observe_execute(w, dt)        wall seconds ``executor.execute`` took at
                                    completion; returns the seconds to fold
                                    into the recorded duration (a measuring
                                    backend counts real per-grain compute,
                                    the sim counts none).

    Incremental (tick-driven) protocol: ``tick_s`` schedules the next tick
    and ``timed_tick`` wraps the executor's real step so a measuring backend
    can time it.  ``begin_job``/``end_job``/``stats`` bracket one job and
    surface backend provenance on ``RuntimeResult.backend``.
    """

    name = "sim"
    runtime: "AsyncRuntime | None" = None

    def bind(self, runtime: "AsyncRuntime") -> None:
        self.runtime = runtime

    # -- lifecycle -----------------------------------------------------------
    def begin_job(self, executor: "GrainExecutor", n_grains: int,
                  now_s: float) -> None:
        pass

    def end_job(self, res: "RuntimeResult") -> None:
        pass

    def stats(self):
        """Backend provenance for reports (None = pure simulation)."""
        return None

    #: Set by the runtime at job start when tracing is on (measuring backends
    #: emit 'start'/'settle' events with real launch/measured timings; the
    #: sim fast path never consults the backend, so SimBackend needs none).
    tracer: Any = None

    # -- modeled/measured grain protocol ------------------------------------
    def launch(self, executor: "GrainExecutor", worker: Any, grain: int,
               cost: float, now_s: float) -> Any:
        return None

    def duration_s(self, executor: "GrainExecutor", worker: Any, grain: int,
                   cost: float, now_s: float, handle: Any) -> float:
        return executor.duration_s(worker, cost, now_s)

    def settle(self, executor: "GrainExecutor", worker: Any, grain: int,
               handle: Any, event_dur_s: float) -> float:
        return event_dur_s

    def observe_execute(self, worker: Any, elapsed_s: float) -> float:
        return 0.0

    # -- incremental (tick) protocol ----------------------------------------
    def tick_s(self, executor: "GrainExecutor", worker: Any,
               now_s: float) -> float:
        return executor.tick_s(worker, now_s)

    def timed_tick(self, executor: "GrainExecutor", worker: Any,
                   now_s: float) -> list[tuple[int, Any]]:
        return executor.tick(worker, now_s)


class SimBackend(ExecutionBackend):
    """The logical-clock default, stated explicitly.  ``AsyncRuntime`` keeps
    a dedicated fast path for this backend (no per-event indirection), so
    ``backend=None``, ``backend=SimBackend()`` and the pre-seam code are all
    bitwise-identical."""


class GrainExecutor:
    """The seam between the event loop and what a grain *is* for one job.

    Subclass (or use ``CallableGrainExecutor``) to define a workload:

      cost(g)                 work units of grain ``g`` (drives allotment,
                              ETAs and heartbeat magnitudes),
      duration_s(w, cost, t)  simulated seconds worker ``w`` needs for
                              ``cost`` units at time ``t`` (jitter hooks in
                              here; defaults to cost / w.perf),
      execute(w, g)           real compute, called exactly once per
                              *completed* grain, at completion time — its
                              return value lands in ``RuntimeResult.values``.

    ``uniform_cost`` set to a float declares every grain equally expensive,
    letting queue-ETA computation run in O(1) instead of O(queue).

    Incremental executors
    ---------------------
    ``incremental = True`` switches a job to the *tick-driven* path for
    workloads whose real compute advances in its own small steps (a
    continuous-batching decode engine): instead of one completion event per
    grain at a model-predicted time, each worker holds up to
    ``concurrency(w)`` grains in flight (its engine slots) and the loop fires
    a *tick* per worker every ``tick_s(w)`` simulated seconds.  A tick
    advances the worker's real compute by one step and reports which grains
    finished — so durations are *measured* (real step counts on a profiled
    step clock), not modeled, and slot-level batching interleaves with
    cross-worker dispatch.  The incremental seam:

      concurrency(w)          in-flight grain capacity (engine slots),
      begin(w, g, t)          admit grain ``g`` into worker ``w``'s real
                              compute (called once per admission),
      tick(w, t)              advance one real step; returns the
                              ``[(grain, value), ...]`` that finished,
      tick_s(w, t)            simulated seconds per real step on ``w``
                              (the worker's speed profile),
      abort(w, g)             withdraw an admitted-but-unfinished grain (kill
                              path) and reset it so re-execution elsewhere is
                              exactly-once on *completed* work,
      heartbeat(w, t)         measured-throughput ``PerfReport`` since the
                              last call (or None); fed to the tracker in
                              place of the modeled per-grain heartbeat,
      remaining_cost(w, g)    unfinished work units of an in-flight grain
                              (ETA accuracy for mid-job re-homogenization).

    Unstarted grains stay in runtime-side queues and migrate/steal exactly as
    in the modeled path; only admitted grains are pinned to their worker.

    Pooled executors
    ----------------
    ``pooled = True`` splits the fleet into named worker pools carrying
    distinct grain classes (prefill/decode disaggregation): ``worker_pool``
    names a worker's pool, ``grain_pool`` names the pool a grain must run in.
    Admission, rebalancing, stealing and kill-heir choice all stay within a
    pool — per-pool homogenized queues.  A pool with work but no live worker
    is a hard error (kill of the last replica of a role), never a silent
    deadlock.  ``followups`` lets a completed grain *defer* new grains into
    the stream (a prefill grain completing hands off a decode grain after a
    transfer delay); deferred grains are declared up front via ``run``'s
    ``n_deferred`` and occupy the top grain ids.  ``shed_with`` names the
    deferred grains that die with a shed grain so termination accounting
    stays exact.
    """

    uniform_cost: float | None = 1.0
    incremental: bool = False
    pooled: bool = False

    # -- pooled seam (used only when ``pooled = True``) ----------------------
    def worker_pool(self, name: str) -> str | None:
        return None

    def grain_pool(self, grain: int) -> str | None:
        return None

    def followups(self, grain: int, value: Any,
                  now_s: float) -> list[tuple[int, float]]:
        """Deferred grains triggered by ``grain``'s completion:
        ``[(new_grain, delay_s), ...]`` arriving ``delay_s`` after now."""
        return []

    def shed_with(self, grain: int) -> list[int]:
        """Deferred grains that can never materialize once ``grain`` is shed
        (they are recorded shed alongside it)."""
        return []

    def cost(self, grain: int) -> float:
        return 1.0 if self.uniform_cost is None else self.uniform_cost

    def duration_s(self, worker: Any, cost: float, now_s: float) -> float:
        return cost / max(getattr(worker, "perf", _EPS), _EPS)

    def execute(self, worker: Any, grain: int) -> Any:
        return None

    # -- incremental seam (used only when ``incremental = True``) -----------
    def concurrency(self, worker: Any) -> int:
        return 1

    def begin(self, worker: Any, grain: int, now_s: float) -> None:
        raise NotImplementedError("incremental executors must define begin()")

    def tick(self, worker: Any, now_s: float) -> list[tuple[int, Any]]:
        raise NotImplementedError("incremental executors must define tick()")

    def tick_s(self, worker: Any, now_s: float) -> float:
        return 1.0 / max(getattr(worker, "perf", _EPS), _EPS)

    def abort(self, worker: Any, grain: int) -> None:
        raise NotImplementedError("incremental executors must define abort()")

    def heartbeat(self, worker: Any, now_s: float) -> PerfReport | None:
        return None

    def remaining_cost(self, worker: Any, grain: int) -> float:
        return self.cost(grain)


class CallableGrainExecutor(GrainExecutor):
    """Adapter for the kwarg form of ``AsyncRuntime.run`` (scalar/callable
    grain cost plus bare ``execute``/``duration_fn`` callables)."""

    def __init__(
        self,
        grain_cost: float | Callable[[int], float] = 1.0,
        execute: Callable[[Any, int], Any] | None = None,
        duration_fn: Callable[[Any, float, float], float] | None = None,
    ):
        if callable(grain_cost):
            self.uniform_cost = None
            self._cost = grain_cost
        else:
            self.uniform_cost = float(grain_cost)
            self._cost = None
        self._execute = execute
        self._duration = duration_fn

    def cost(self, grain: int) -> float:
        return self.uniform_cost if self._cost is None else self._cost(grain)

    def duration_s(self, worker: Any, cost: float, now_s: float) -> float:
        if self._duration is not None:
            return self._duration(worker, cost, now_s)
        return super().duration_s(worker, cost, now_s)

    def execute(self, worker: Any, grain: int) -> Any:
        return self._execute(worker, grain) if self._execute else None


class ArrivalSource:
    """The open-loop seam: grains *arrive* at scheduled logical times instead
    of all existing at job start.

    ``times[g]`` is grain ``g``'s arrival, in simulated seconds after the
    job's start.  A job run with an ArrivalSource skips the up-front
    homogenized plan (there is nothing to plan yet); each grain is admitted
    on arrival to the live worker with the earliest predicted drain time
    (ETA under the tracker's learned perfs — join-the-homogenized-shortest
    queue).  Admission control happens here too: with a ``max_queue_depth``
    bound, a grain arriving when every live worker's unstarted queue is full
    is either held in a runtime backlog (``overflow='queue'``, drained as
    queues free up) or *shed* with an explicit reject record
    (``overflow='shed'``, ``RuntimeResult.shed``) — arrivals never wait for
    the fleet.  Once admitted, grains migrate/steal exactly as in the
    closed-loop path."""

    def __init__(self, times):
        self.times = tuple(float(t) for t in times)
        if any(t < 0 for t in self.times):
            raise ValueError("arrival times must be >= 0 (job-relative)")

    def __len__(self) -> int:
        return len(self.times)


@dataclasses.dataclass
class SimWorker:
    """Minimal runtime worker: a name and a *true* instantaneous perf
    (work-units/sec).  ``perf`` is mutable so timeline events can degrade or
    restore it mid-job; the tracker only ever sees it through observed grain
    latencies."""

    name: str
    perf: float


@dataclasses.dataclass(frozen=True)
class TimelineEvent:
    """Scripted mid-job fleet change, in absolute simulated seconds.

    Worker-plane kinds:

    kind = "perf":  worker's true perf becomes ``perf`` (tracker finds out
                    only through subsequent heartbeats),
    kind = "kill":  worker dies; its in-flight grain aborts and re-queues,
    kind = "join":  ``worker`` is a new worker object; ``perf`` is the prior
                    reported to the tracker (defaults to the worker's true
                    perf).

    Coordinator-plane kinds (handled by the runtime's ``DispatchAuthority``;
    a single-coordinator runtime rejects them):

    kind = "ckill":     coordinator shard ``worker`` (an int id) dies; its
                        queues and in-flight bookkeeping are taken over by
                        its ring successor,
    kind = "partition": gossip/steal connectivity splits into the groups in
                        ``worker`` (a tuple of tuples of shard ids),
    kind = "heal":      the partition heals (``worker`` is None).

    Workload-plane kinds (compiled from Scenario ``arrive:``/``burst:``/
    ``mix:`` clauses; *consumed by the serving layer* when it materializes an
    ``ArrivalSource`` — a runtime handed one directly rejects it):

    kind = "arrive":    ``worker`` is a tuple of arrival offsets (seconds
                        after ``time_s``) — one grain arrives per offset,
    kind = "mix":       request-mix shift: lengths of requests arriving at or
                        after ``time_s`` scale by ``perf``.
    """

    time_s: float
    kind: str
    worker: Any                     # worker name (perf/kill) or object (join)
    perf: float | None = None

    def __post_init__(self):
        if self.kind not in ("perf", "kill", "join", *_COORD_KINDS,
                             *_WORKLOAD_KINDS):
            raise ValueError(f"unknown timeline kind {self.kind!r}")
        if self.kind == "arrive" and not (
            isinstance(self.worker, tuple)
            and all(isinstance(o, float) and o >= 0 for o in self.worker)
        ):
            raise ValueError(
                "arrive event needs a tuple of float arrival offsets >= 0"
            )
        if self.kind == "mix" and (self.perf is None or self.perf <= 0):
            raise ValueError("mix event needs a scale factor perf > 0")
        if self.kind == "perf" and (self.perf is None or self.perf <= 0):
            raise ValueError("perf event needs perf > 0")
        if self.kind == "ckill" and not (
            isinstance(self.worker, int) and self.worker >= 0
        ):
            raise ValueError("ckill event needs a shard id >= 0")
        if self.kind == "partition" and not (
            isinstance(self.worker, tuple) and self.worker
            and all(isinstance(g, tuple) and g for g in self.worker)
        ):
            raise ValueError(
                "partition event needs a non-empty tuple of shard-id groups"
            )


@dataclasses.dataclass(frozen=True)
class GrainRecord:
    grain: int
    worker: str
    start_s: float
    end_s: float
    cost: float


@dataclasses.dataclass
class RuntimeResult:
    """One job's execution record.  User-facing consumers should prefer the
    unified ``repro.cluster.RunReport`` (the ``Cluster`` facade builds it
    from these); RuntimeResult stays the substrate-level truth."""

    makespan: float                  # last completion relative to job start
    records: list[GrainRecord]
    values: dict[int, Any]           # grain -> execute() result (or None)
    executed_by: dict[int, str]      # grain -> completing worker (exactly one)
    worker_finish: dict[str, float]  # last completion time per worker (abs)
    worker_busy: dict[str, float]    # total compute seconds per worker
    n_replans: int
    n_migrated: int
    n_steals: int
    end_s: float                     # absolute clock at job end
    dead_workers: set[str] = dataclasses.field(default_factory=set)
    coord: Any = None                # coordination-plane stats (CoordStats)
    backend: Any = None              # execution-backend stats (WallclockStats;
                                     # None = pure logical-clock simulation)
    # Open-loop extras (ArrivalSource jobs; empty for closed-loop jobs):
    arrive_s: dict[int, float] = dataclasses.field(default_factory=dict)
    shed: list[int] = dataclasses.field(default_factory=list)

    def shares(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for w in self.executed_by.values():
            counts[w] = counts.get(w, 0) + 1
        return counts

    def homogenization_quality(self, workers: list[str] | None = None) -> float:
        """Max/min last-completion spread across workers that did work
        (1.0 = everyone crossed the homogenization line together).

        Workers that died during the job are excluded by default: a killed
        worker's truncated span is a death artifact, not a dispatch failure —
        the homogenization question is whether the *survivors* crossed the
        line together (pass ``workers=`` to override)."""
        names = workers if workers is not None else [
            w for w in self.worker_finish if w not in self.dead_workers
        ]
        start = self.end_s - self.makespan
        spans = [
            self.worker_finish[w] - start
            for w in names
            if self.worker_finish.get(w, 0.0) > start
        ]
        if len(spans) < 2:
            return 1.0
        return max(spans) / max(min(spans), _EPS)


@dataclasses.dataclass(slots=True)
class _Inflight:
    grain: int
    start_s: float
    end_s: float
    cost: float
    handle: Any = None        # ExecutionBackend launch handle (None for sim)


class AsyncRuntime:
    """The event-loop substrate.  One instance can run many jobs against the
    same tracker (heartbeat state persists, so later jobs start from learned
    perfs — the closed loop of the paper's background process)."""

    def __init__(
        self,
        workers: list[Any],
        tracker: PerformanceTracker | None = None,
        *,
        homogenize: bool = True,
        rehomogenize: bool = True,
        steal: bool = True,
        replan_threshold: float = 0.05,
        authority: DispatchAuthority | None = None,
        eta_mode: str | None = None,
        backend: ExecutionBackend | None = None,
        tracer: Any = None,
    ):
        if eta_mode is None:
            # Benchmark/debug override: lets harnesses A/B the reference
            # recompute path through facades that don't expose the knob.
            eta_mode = os.environ.get("REPRO_ETA_MODE", "incremental")
        if eta_mode not in ("incremental", "recompute"):
            raise ValueError("eta_mode must be 'incremental' or 'recompute'")
        self.tracker = tracker or PerformanceTracker(alpha=0.5)
        self.workers: dict[str, Any] = {}
        self.homogenize = homogenize
        self.rehomogenize = rehomogenize
        self.steal = steal
        self.replan_threshold = replan_threshold
        # 'incremental' (default) maintains per-worker queue/in-flight cost
        # totals at O(1) per mutation; 'recompute' re-sums queues on every ETA
        # call — the pre-optimization reference path, kept for the bitwise
        # property sweep (tests/test_eta_incremental.py) and A/B benching.
        self.eta_mode = eta_mode
        self.clock = 0.0
        self.authority = authority or SingleCoordinator()
        self.authority.bind(self)
        # ``backend`` decides where grain durations come from: None (or a
        # SimBackend) keeps the logical-clock fast path; a measuring backend
        # (core.wallclock.WallclockBackend) launches real work per grain.
        self.backend = backend or SimBackend()
        self.backend.bind(self)
        # ``tracer`` (obs.Tracer or None) observes the run: every emit site
        # is guarded by a single ``tracer is not None`` branch on a local, so
        # the off path stays bitwise-identical and within noise on bench_loop
        # (tests/test_obs.py asserts the first, the bench asserts the second).
        # Plain attribute: facades may attach one per job after construction.
        self.tracer = tracer
        # Timeline events scheduled past a job's last completion don't fire in
        # that job; they carry over and fire during a later job's window.
        self._pending: list[TimelineEvent] = []
        # Set while run() is looping: pushes an event into the live heap
        # (inject_event's reactive path).
        self._live_push: Callable[[TimelineEvent], None] | None = None
        for w in workers:
            self._register(w, now_s=0.0)

    # -- fleet -------------------------------------------------------------
    def _register(self, worker: Any, now_s: float, perf_prior: float | None = None):
        if not hasattr(worker, "name") or not hasattr(worker, "perf"):
            raise TypeError("runtime workers need .name and .perf")
        self.workers[worker.name] = worker
        if worker.name not in self.tracker.workers():
            # Unknown worker: neutral prior until real heartbeats arrive.
            # Previously-killed worker: this registration *is* the explicit
            # rejoin (observe alone would be rejected — kills are sticky).
            self.tracker.rejoin(worker.name, perf_prior or 1.0, now_s)
        self.authority.on_join(worker.name)

    def add_worker(self, worker: Any, perf_prior: float | None = None) -> None:
        """Between-job join (the ``TimelineEvent('join')`` is the mid-job
        form): the worker enters the fleet with ``perf_prior`` (or a neutral
        1.0) until heartbeats teach the tracker its real speed."""
        self._register(worker, now_s=self.clock, perf_prior=perf_prior)

    def remove_worker(self, name: str) -> None:
        """Between-job kill: drop from the fleet and mark dead in the tracker
        so no later heartbeat resurrects it (rejoining requires add_worker or
        a 'join' timeline event)."""
        self.workers.pop(name, None)
        self.tracker.mark_dead(name)
        self.authority.on_worker_kill(name)

    # -- job ---------------------------------------------------------------
    def run(
        self,
        n_grains: int,
        *,
        executor: GrainExecutor | None = None,
        grain_cost: float | Callable[[int], float] = 1.0,
        execute: Callable[[Any, int], Any] | None = None,
        duration_fn: Callable[[Any, float, float], float] | None = None,
        timeline: tuple[TimelineEvent, ...] | list[TimelineEvent] = (),
        timeline_relative: bool = False,
        initial_plan: GrainPlan | None = None,
        start_s: float | None = None,
        arrivals: ArrivalSource | None = None,
        max_queue_depth: int | None = None,
        overflow: str = "queue",
        n_deferred: int = 0,
    ) -> RuntimeResult:
        """Run one job of ``n_grains`` grains to completion.

        ``executor``    — the job's ``GrainExecutor`` (cost model, timing,
                          real compute).  Alternatively pass the kwarg form:
        ``grain_cost``  — work units per grain (scalar or per-grain callable).
        ``execute``     — real compute, called exactly once per completed
                          grain, at completion time: ``execute(worker, grain)``.
        ``duration_fn`` — simulated seconds for (worker, cost, now); defaults
                          to ``cost / worker.perf`` (jitter hooks in here).
        ``timeline``    — scripted perf shifts / deaths / joins, in absolute
                          simulated time, or relative to this job's start when
                          ``timeline_relative=True``.  Events landing past the
                          job's last completion carry over to the next job.
        ``initial_plan``— caller-provided allotment (e.g. ``TDAServer``'s);
                          otherwise planned from the tracker's perf vector.
        ``arrivals``    — open-loop mode: ``ArrivalSource`` (or a sequence of
                          job-relative arrival seconds, one per grain).  The
                          up-front plan is skipped; grains are admitted on
                          arrival to the min-ETA live worker with queue room.
        ``max_queue_depth`` — per-worker unstarted-queue bound for open-loop
                          admission control (requires ``arrivals``).
        ``overflow``    — what happens to a grain arriving when every live
                          queue is full: ``'queue'`` holds it in a runtime
                          backlog, ``'shed'`` rejects it
                          (``RuntimeResult.shed``).
        ``n_deferred``  — grains (the top ``n_deferred`` ids) that have no
                          scheduled arrival: they enter the stream when an
                          earlier grain's completion defers them
                          (``executor.followups`` — the KV-handoff pattern).
                          Deferred grains are in-progress work, so they
                          backlog rather than shed on overflow.
        """
        if n_grains < 0:
            raise ValueError("n_grains must be >= 0")
        if overflow not in ("queue", "shed"):
            raise ValueError("overflow must be 'queue' or 'shed'")
        if arrivals is not None and not isinstance(arrivals, ArrivalSource):
            arrivals = ArrivalSource(arrivals)
        if arrivals is not None and initial_plan is not None:
            raise ValueError(
                "arrivals and initial_plan are mutually exclusive: an "
                "open-loop job has no up-front allotment to execute"
            )
        if not 0 <= n_deferred <= n_grains:
            raise ValueError(
                f"n_deferred must be in [0, n_grains], got {n_deferred}"
            )
        if n_deferred and arrivals is None:
            raise ValueError(
                "n_deferred needs arrivals=: deferred grains extend an "
                "open-loop stream (executor.followups injects them)"
            )
        if arrivals is not None and len(arrivals) != n_grains - n_deferred:
            raise ValueError(
                f"arrivals covers {len(arrivals)} grains, job has "
                f"{n_grains - n_deferred} non-deferred"
            )
        if max_queue_depth is not None:
            if arrivals is None:
                raise ValueError(
                    "max_queue_depth bounds open-loop admission; pass "
                    "arrivals= (closed-loop admission control lives in the "
                    "serving layer's wave quota)"
                )
            if max_queue_depth < 1:
                raise ValueError("max_queue_depth must be >= 1")
        if executor is None:
            executor = CallableGrainExecutor(grain_cost, execute, duration_fn)
        elif (execute is not None or duration_fn is not None
              or callable(grain_cost) or grain_cost != 1.0):
            raise ValueError(
                "pass either executor= or the grain_cost/execute/duration_fn "
                "kwargs, not both"
            )
        now = self.clock if start_s is None else max(start_s, self.clock)
        uniform = executor.uniform_cost
        cost_of = executor.cost
        dur_of = executor.duration_s
        backend = self.backend
        # The sim default keeps the exact pre-seam call sequence (no per-event
        # backend indirection): bitwise-identical results, identical hot path.
        sim_exec = type(backend) in (SimBackend, ExecutionBackend)
        # Same idiom for tracing: one local, one None-check per emit site.
        tracer = self.tracer
        pooled = executor.pooled
        defers = n_deferred > 0
        n_direct = n_grains - n_deferred

        events = [
            dataclasses.replace(ev, time_s=ev.time_s + now) for ev in timeline
        ] if timeline_relative else list(timeline)
        events.extend(self._pending)
        self._pending = []

        res = RuntimeResult(
            makespan=0.0, records=[], values={}, executed_by={},
            worker_finish={}, worker_busy={}, n_replans=0, n_migrated=0,
            n_steals=0, end_s=now,
        )
        if n_grains == 0:
            self._pending = events
            self.clock = now
            return res

        track_cost = uniform is None and self.eta_mode == "incremental"
        if track_cost:
            def make_queue(grains=()):
                return _CostedQueue(cost_of, grains)
        else:
            make_queue = deque
        if arrivals is not None:
            queues = {w: make_queue() for w in self.workers}
        else:
            queues = self._initial_queues(n_grains, now, initial_plan,
                                          make_queue)
        backlog: deque[int] = deque()
        incremental = executor.incremental
        inflight: dict[str, _Inflight] = {}
        # Incremental mode: several grains in flight per worker (engine
        # slots), each mapped to its admission time; one pending tick per
        # worker, remembered as (fire_s, tick_duration).
        islots: dict[str, dict[int, float]] = {}
        ticks: dict[str, tuple[float, float]] = {}
        dead: set[str] = set()
        heap: list[tuple[float, int, int, Any]] = []   # (t, priority, seq, payload)
        seq = itertools.count()
        start_clock = now

        for ev in sorted(events, key=lambda e: e.time_s):
            heapq.heappush(heap, (max(ev.time_s, now), 0, next(seq), ev))
        if arrivals is not None:
            # Priority 2: an arrival at time t sees completions at t first,
            # so a slot freed at exactly t is visible to admission control.
            for g, t in enumerate(arrivals.times):
                heapq.heappush(heap, (now + t, 2, next(seq), g))

        # Alive-worker list, maintained on kill/join instead of rebuilt per
        # event; mirrors [w for w in self.workers if w not in dead] exactly
        # (dict insertion order; kills remove, joins append).
        live_list: list[str] = [w for w in self.workers if w not in dead]
        # Workers that may need a (re)start: a superset of {live and not
        # in-flight}, pruned on start/kill.  kick_idle iterates it in
        # live-list order, so the sequence of *acting* start_next calls is
        # identical to scanning every live worker (start_next is a no-op for
        # busy/dead workers).  Modeled path only; incremental admit() has
        # its own slot logic.
        idle: set[str] = set(live_list)
        # In-flight remaining-cost totals per worker (incremental executors).
        # remaining_cost only changes through begin/tick/abort — the three
        # sites that invalidate this cache — so cached sums stay exact.
        icost_cache: dict[str, float] = {}
        recompute = self.eta_mode == "recompute"

        def alive() -> list[str]:
            if recompute:
                # Reference: rebuild per call, as the pre-fast-path loop did.
                return [w for w in self.workers if w not in dead]
            return live_list

        def est_perf(w: str) -> float:
            try:
                return max(self.tracker.perf(w, now), _EPS)
            except KeyError:
                return _EPS

        def inflight_cost(w: str) -> float:
            """Total remaining work units in w's occupied slots (caller
            guarantees islots[w] is non-empty)."""
            if recompute:
                sl = islots[w]
                return sum(
                    executor.remaining_cost(self.workers[w], g) for g in sl
                )
            c = icost_cache.get(w)
            if c is None:
                sl = islots[w]
                c = sum(
                    executor.remaining_cost(self.workers[w], g) for g in sl
                )
                icost_cache[w] = c
            return c

        def queue_cost(q) -> float:
            if uniform is not None:
                return len(q) * uniform
            if recompute:
                return sum(cost_of(g) for g in q)
            return q.cost

        def eta_with(w: str, perf_of: Callable[[str], float]) -> float:
            """Predicted seconds until worker w's queue drains (from `now`)
            under the perf estimate ``perf_of`` — the global tracker's for
            the single coordinator, a shard's gossiped view for a sharded
            one.  The scheduler never peeks at true perf."""
            p = max(perf_of(w), _EPS)
            if incremental:
                t = inflight_cost(w) / p if islots.get(w) else 0.0
            else:
                t = inflight[w].end_s - now if w in inflight else 0.0
            q = queues.get(w)
            if q:
                t += queue_cost(q) / p
            return t

        def eta(w: str) -> float:
            return eta_with(w, est_perf)

        def etas_under(ws, pmap) -> dict[str, float]:
            """Bulk ``eta_with``: one tight pass over ``ws`` given perf
            estimates already floored at _EPS.  Bitwise-identical to calling
            eta_with per worker — this is the per-event hot path, specialized
            per mode so the inner loop carries no per-worker branching."""
            out = {}
            if incremental:
                for w in ws:
                    p = pmap[w]
                    t = inflight_cost(w) / p if islots.get(w) else 0.0
                    q = queues.get(w)
                    if q:
                        t += queue_cost(q) / p
                    out[w] = t
            elif uniform is not None:
                fl_get = inflight.get
                for w in ws:
                    fl = fl_get(w)
                    t = fl.end_s - now if fl is not None else 0.0
                    q = queues[w]
                    if q:
                        t += len(q) * uniform / pmap[w]
                    out[w] = t
            else:
                fl_get = inflight.get
                for w in ws:
                    fl = fl_get(w)
                    t = fl.end_s - now if fl is not None else 0.0
                    q = queues[w]
                    if q:
                        t += queue_cost(q) / pmap[w]
                    out[w] = t
            return out

        def perf_map(ws) -> dict[str, float]:
            return self.tracker.perf_map(ws, now, floor=_EPS)

        def etas_under_view(ws, entries_get, half_life):
            """Fused gossip-view decay + bulk ETA: one pass per worker
            computing the ETA under the view's floored, staleness-decayed
            perf (bitwise-identical to ``PerfView.perf_floor_map`` followed
            by ``etas_under``) — the sharded authority's per-event hot path.
            The decay is evaluated lazily: a worker with nothing queued and
            nothing in flight has ETA 0.0 under *any* perf, so its decay
            never runs.  Returns ``(est, etas)`` where ``est(w)`` yields the
            decayed perf on demand (memoized; for the rebalance move loop)."""
            pmap: dict[str, float] = {}
            etas: dict[str, float] = {}

            def est(w: str) -> float:
                p = pmap.get(w)
                if p is None:
                    e = entries_get(w)
                    if e is None:
                        p = 1.0
                    else:
                        p = e.perf
                        stamp = e.stamp
                        if now > stamp:
                            p *= 0.5 ** ((now - stamp) / half_life)
                    p = p if p >= _EPS else _EPS
                    pmap[w] = p
                return p

            if incremental:
                for w in ws:
                    sl = islots.get(w)
                    q = queues.get(w)
                    if sl or q:
                        e = entries_get(w)
                        if e is None:
                            p = 1.0
                        else:
                            p = e.perf
                            stamp = e.stamp
                            if now > stamp:
                                p *= 0.5 ** ((now - stamp) / half_life)
                        p = p if p >= _EPS else _EPS
                        pmap[w] = p
                        t = inflight_cost(w) / p if sl else 0.0
                        if q:
                            t += queue_cost(q) / p
                    else:
                        t = 0.0
                    etas[w] = t
            else:
                fl_get = inflight.get
                for w in ws:
                    fl = fl_get(w)
                    t = fl.end_s - now if fl is not None else 0.0
                    q = queues[w]
                    if q:
                        e = entries_get(w)
                        if e is None:
                            p = 1.0
                        else:
                            p = e.perf
                            stamp = e.stamp
                            if now > stamp:
                                p *= 0.5 ** ((now - stamp) / half_life)
                        p = p if p >= _EPS else _EPS
                        pmap[w] = p
                        if uniform is not None:
                            t += len(q) * uniform / p
                        else:
                            t += queue_cost(q) / p
                    etas[w] = t
            return est, etas

        ctx = JobContext(
            queues=queues, dead=dead, res=res, cost_of=cost_of,
            est_perf=est_perf, eta=eta, eta_with=eta_with,
            clock=lambda: now, n_grains=n_grains,
            live=live_list, etas_under=etas_under, perf_map=perf_map,
            etas_under_view=etas_under_view,
            new_queue=make_queue, idle=idle,
            pool_of=executor.worker_pool if pooled else None,
        )
        self.authority.begin_job(ctx)
        if not sim_exec:
            backend.begin_job(executor, n_grains, now)
            backend.tracer = tracer
        if tracer is not None:
            # Inject the live clock so emit sites with no ``now`` in scope
            # (rebalance moves, steals, gossip rounds) stamp correctly.
            tracer.set_clock(ctx.clock)
            for tw, tq in queues.items():
                for tg in tq:
                    tracer.emit("enqueue", t_s=now, worker=tw, grain=tg)

        def abort_inflight(w: str) -> list[int]:
            """Withdraw w's never-completed in-flight work (kill path) so the
            heir re-executes it from scratch — exactly-once on *completed*
            grains.  Returns the orphaned grain ids in admission order."""
            if incremental:
                sl = islots.pop(w, {})
                icost_cache.pop(w, None)
                gs = sorted(sl, key=sl.get)
                for g in gs:
                    executor.abort(self.workers[w], g)
                    if tracer is not None:
                        tracer.emit("abort", t_s=now, worker=w, grain=g)
                ticks.pop(w, None)
                return gs
            fl = inflight.pop(w, None)
            if fl is not None and tracer is not None:
                tracer.emit("abort", t_s=now, worker=w, grain=fl.grain)
            return [fl.grain] if fl is not None else []

        def start_next(w: str) -> None:
            if incremental:
                admit(w)
                return
            if w in dead or w in inflight:
                return
            q = queues[w]
            if not q and self.steal:
                self.authority.steal_for(w, ctx)
            if not q:
                return
            g = q.popleft()
            c = cost_of(g)
            if sim_exec:
                d = max(dur_of(self.workers[w], c, now), _EPS)
                h = None
            else:
                # Measuring backend: launch the grain's real work now; the
                # completion event lands at its (measured or estimated)
                # duration and settles against the handle.
                h = backend.launch(executor, self.workers[w], g, c, now)
                d = max(backend.duration_s(executor, self.workers[w], g, c,
                                           now, h), _EPS)
            inflight[w] = _Inflight(g, now, now + d, c, h)
            idle.discard(w)
            if tracer is not None:
                tracer.emit("dispatch", t_s=now, worker=w, grain=g, cost=c)
            heapq.heappush(heap, (now + d, 1, next(seq), w))

        def admit(w: str) -> None:
            """Fill w's free slots from its queue (stealing first if the
            queue ran dry) and make sure a tick is pending while any slot is
            occupied — this is where request-bundle admission meets
            continuous batching."""
            if w in dead:
                return
            sl = islots.setdefault(w, {})
            worker = self.workers[w]
            free = executor.concurrency(worker) - len(sl)
            q = queues[w]
            if not q and free > 0 and self.steal:
                self.authority.steal_for(w, ctx)
            while free > 0 and q:
                g = q.popleft()
                executor.begin(worker, g, now)
                sl[g] = now
                icost_cache.pop(w, None)
                free -= 1
                if tracer is not None:
                    tracer.emit("dispatch", t_s=now, worker=w, grain=g)
            if sl and w not in ticks:
                if sim_exec:
                    d = max(executor.tick_s(worker, now), _EPS)
                else:
                    d = max(backend.tick_s(executor, worker, now), _EPS)
                ticks[w] = (now + d, d)
                heapq.heappush(heap, (now + d, 1, next(seq), w))

        def admit_arrival(g: int) -> str | None:
            """Join-the-homogenized-shortest-queue admission: the live worker
            with the earliest predicted drain time among those with queue
            room, or None when every live queue is at max_queue_depth.
            Pooled jobs admit only into the grain's pool; an empty pool is a
            hard error (the last replica of a role died), never a wait."""
            cands = alive() if recompute else live_list
            if pooled:
                pool = executor.grain_pool(g)
                if pool is not None:
                    cands = [w for w in cands
                             if executor.worker_pool(w) == pool]
                    if not cands:
                        raise RuntimeError(
                            f"no live {pool!r} worker to admit grain {g}: "
                            f"the {pool} pool is empty (killed its last "
                            "replica?) — a role-disaggregated fleet needs at "
                            "least one live worker per role"
                        )
            room = [
                w for w in cands
                if max_queue_depth is None or len(queues[w]) < max_queue_depth
            ]
            if not room:
                return None
            if recompute:
                w = min(room, key=eta)   # reference: per-worker closure chain
            else:
                em = etas_under(room, perf_map(room))
                w = min(room, key=em.__getitem__)
            queues[w].append(g)
            if tracer is not None:
                tracer.emit("admit", t_s=now, worker=w, grain=g)
            return w

        def kick_idle() -> None:
            if incremental:
                for w in list(live_list):
                    admit(w)
            elif recompute:
                # Reference: scan every live worker (start_next no-ops on
                # busy ones) instead of consulting the idle set.
                for w in alive():
                    start_next(w)
            elif len(idle) == 1:
                start_next(next(iter(idle)))
            elif idle:
                # live-list order, same as scanning every live worker.
                for w in sorted(idle, key=live_list.index):
                    start_next(w)
            if pooled:
                # First-fit scan: a full prefill pool must not block a
                # backlogged decode handoff behind it (head-of-line).
                i = 0
                while i < len(backlog):
                    w = admit_arrival(backlog[i])
                    if w is None:
                        i += 1
                        continue
                    del backlog[i]
                    start_next(w)
                return
            while backlog:
                w = admit_arrival(backlog[0])
                if w is None:
                    break
                backlog.popleft()
                start_next(w)

        def live_push(ev: TimelineEvent) -> None:
            # Reactive injection (autoscaler join on an SLO breach): the
            # event enters the running loop no earlier than the current clock.
            heapq.heappush(heap, (max(ev.time_s, now), 0, next(seq), ev))

        self._live_push = live_push
        kick_idle()
        while len(res.values) + len(res.shed) < n_grains:
            if not heap:
                if not alive():
                    raise RuntimeError("all workers dead with grains pending")
                raise RuntimeError("runtime stalled with grains pending")
            now, prio, _, payload = heapq.heappop(heap)
            self.authority.advance(now, ctx)

            if prio == 2:  # open-loop arrival
                g = payload
                res.arrive_s[g] = now
                if tracer is not None:
                    tracer.emit("arrive", t_s=now, grain=g)
                if not alive():
                    raise RuntimeError("all workers dead with grains pending")
                w = admit_arrival(g)
                if w is None:
                    if overflow == "shed" and not (defers and g >= n_direct):
                        res.shed.append(g)
                        if tracer is not None:
                            tracer.emit("shed", t_s=now, grain=g)
                        if defers:
                            # The shed grain's deferred follow-ups can never
                            # materialize — record them shed too, or the
                            # termination count never closes.
                            for extra in executor.shed_with(g):
                                res.shed.append(extra)
                                res.arrive_s[extra] = now
                                if tracer is not None:
                                    tracer.emit("shed", t_s=now, grain=extra)
                        self.authority.count_event(None, "shed", ctx)
                        continue
                    # Deferred grains carry in-progress work (a produced KV
                    # handoff): they backlog, never shed.
                    backlog.append(g)
                    continue
                self.authority.count_event(w, "arrive", ctx)
                start_next(w)
                continue

            if prio == 0:  # timeline event
                self.authority.count_event(
                    payload.worker if isinstance(payload.worker, str) else None,
                    "timeline", ctx,
                )
                if tracer is not None:
                    tw = payload.worker
                    tracer.emit(
                        "fault", t_s=now,
                        worker=tw if isinstance(tw, str)
                        else getattr(tw, "name", None),
                        fault=payload.kind,
                        **({"perf": payload.perf}
                           if payload.perf is not None else {}),
                    )
                self._apply_timeline(payload, now, queues, abort_inflight,
                                     dead, ctx)
                if self.rehomogenize:
                    self.authority.rebalance(ctx)
                kick_idle()
                continue

            w = payload
            if incremental:
                tk = ticks.get(w)
                if w in dead or tk is None or abs(tk[0] - now) > 1e-9:
                    continue  # stale tick (worker died)
                del ticks[w]
                self.authority.count_event(w, "tick", ctx)
                worker = self.workers[w]
                if sim_exec:
                    finished = executor.tick(worker, now)
                else:
                    finished = backend.timed_tick(executor, worker, now)
                icost_cache.pop(w, None)
                sl = islots.get(w, {})
                res.worker_busy[w] = res.worker_busy.get(w, 0.0) + tk[1]
                for g, val in finished:
                    if g not in sl:
                        raise RuntimeError(
                            f"worker {w} finished grain {g} it was never assigned"
                        )
                    if g in res.executed_by:
                        raise RuntimeError(f"grain {g} double-executed")
                    g_start = sl.pop(g)
                    res.records.append(GrainRecord(g, w, g_start, now, cost_of(g)))
                    res.executed_by[g] = w
                    res.values[g] = val
                    res.worker_finish[w] = now
                    if tracer is not None:
                        tracer.emit("complete", t_s=now, worker=w, grain=g,
                                    start_s=g_start)
                if defers and finished:
                    # Completion-triggered deferred arrivals (KV handoff:
                    # a finished prefill grain schedules its decode grain
                    # after the modeled transfer delay).
                    for g, val in finished:
                        for ng, delay in executor.followups(g, val, now):
                            if tracer is not None:
                                tracer.emit("handoff", t_s=now, worker=w,
                                            grain=g, to_grain=ng,
                                            delay_s=delay)
                            heapq.heappush(
                                heap,
                                (now + max(delay, 0.0), 2, next(seq), ng),
                            )
                # Measured heartbeat: real tokens over real steps on this
                # worker's step clock — replaces the modeled per-grain report.
                hb = executor.heartbeat(worker, now)
                if hb is not None:
                    self.authority.observe(hb, ctx)
                    if tracer is not None:
                        tracer.emit("heartbeat", t_s=now, worker=w,
                                    work=hb.work_done, elapsed_s=hb.elapsed_s)
                if finished and self.rehomogenize:
                    self.authority.rebalance(ctx, worker=w)
                kick_idle()
                continue

            fl = inflight.get(w)
            if fl is None or w in dead or abs(fl.end_s - now) > 1e-9:
                continue  # stale event (worker died or grain was aborted)
            del inflight[w]
            idle.add(w)
            self.authority.count_event(w, "completion", ctx)
            dur = now - fl.start_s
            if not sim_exec:
                # Measured duration: the backend blocks on the grain's real
                # async work here (or returns the time it already measured).
                dur = backend.settle(executor, self.workers[w], fl.grain,
                                     fl.handle, dur)
            res.records.append(GrainRecord(fl.grain, w, fl.start_s, now, fl.cost))
            if fl.grain in res.executed_by:
                raise RuntimeError(f"grain {fl.grain} double-executed")
            res.executed_by[fl.grain] = w
            if tracer is not None:
                tracer.emit("complete", t_s=now, worker=w, grain=fl.grain,
                            start_s=fl.start_s, cost=fl.cost)
            if sim_exec:
                res.values[fl.grain] = executor.execute(self.workers[w], fl.grain)
            else:
                # Real per-grain compute counts toward the measured duration
                # (the sim charges it to the cost model instead).
                t0 = _perf_counter()
                res.values[fl.grain] = executor.execute(self.workers[w], fl.grain)
                dur += backend.observe_execute(
                    self.workers[w], _perf_counter() - t0)
            res.worker_finish[w] = now
            res.worker_busy[w] = res.worker_busy.get(w, 0.0) + dur
            # Heartbeat: the background process reports observed throughput.
            self.authority.observe(PerfReport(w, fl.cost, max(dur, _EPS), now), ctx)
            if tracer is not None:
                tracer.emit("heartbeat", t_s=now, worker=w, work=fl.cost,
                            elapsed_s=max(dur, _EPS))
            if self.rehomogenize:
                self.authority.rebalance(ctx, worker=w)
            kick_idle()

        # Unfired timeline events (scheduled past the last completion) carry
        # over so a later job on this runtime still sees them.
        self._live_push = None
        self._pending = [p for _, prio, _, p in heap if prio == 0]
        self.clock = now
        res.end_s = now
        res.makespan = now - start_clock
        res.dead_workers = set(dead)
        self.authority.end_job(ctx)
        res.coord = self.authority.stats()
        if not sim_exec:
            backend.end_job(res)
            res.backend = backend.stats()
        return res

    def inject_event(self, ev: TimelineEvent) -> None:
        """Schedule a timeline event reactively.

        During a ``run`` the event enters the live loop at
        ``max(ev.time_s, clock)`` — this is how a metric-driven controller
        (the serve-layer autoscaler on a p99 breach) turns an observation
        into a mid-job ``join`` without scripting it up front.  Outside a run
        it lands in the carry-over set the next job replays."""
        if self._live_push is not None:
            self._live_push(ev)
        else:
            self._pending.append(ev)

    def plan(self, n_grains: int, now_s: float | None = None) -> GrainPlan:
        """The allotment a job of ``n_grains`` would start from — a pure
        function of the tracker's perf vector at ``now_s`` (default: the
        current clock).  This is exactly what ``run`` executes when no
        ``initial_plan`` is passed, so callers can preview/verify plans
        (e.g. restart-continuity assertions) against one implementation."""
        sched = HomogenizedScheduler(
            self.tracker, total_grains=n_grains,
            replan_threshold=self.replan_threshold,
            homogenize=self.homogenize,
        )
        return sched.plan(
            now_s=self.clock if now_s is None else now_s, force=True
        )

    # -- internals ---------------------------------------------------------
    def _initial_queues(
        self, n_grains: int, now: float, plan: GrainPlan | None,
        make_queue: Callable[[], deque] = deque,
    ) -> dict[str, deque[int]]:
        if plan is None:
            plan = self.plan(n_grains, now_s=now)
        elif plan.total_grains != n_grains:
            raise ValueError(
                f"initial_plan covers {plan.total_grains} grains, job has {n_grains}"
            )
        unknown = set(plan.workers) - set(self.workers)
        if unknown:
            raise ValueError(f"plan names unknown workers {sorted(unknown)}")
        queues = {w: make_queue() for w in self.workers}
        start = 0
        for w, share in zip(plan.workers, plan.shares, strict=True):
            queues[w].extend(range(start, start + share))
            start += share
        return queues

    def _steal_into(self, thief, queues, eta, est_perf, res) -> int:
        """Idle worker steals the tail of the worst-ETA queue, split by
        scope_lengths over {victim, thief} — proportional re-homogenization
        of the victim's remainder.  ``queues`` may be a sub-fleet (one
        coordinator shard's workers); returns the number of grains moved."""
        victims = [w for w, q in queues.items() if q and w != thief]
        if not victims:
            return 0
        victim = max(victims, key=eta)
        q = queues[victim]
        shares = scope_lengths(len(q), [est_perf(victim), est_perf(thief)])
        take = shares[1]
        if take <= 0 and len(q) > 1:
            take = 1  # a slow-estimated thief still beats an idle one
        if take <= 0:
            return 0
        stolen = [q.pop() for _ in range(take)]
        queues[thief].extend(reversed(stolen))
        res.n_steals += 1
        res.n_migrated += take
        tracer = self.tracer
        if tracer is not None:
            for g in reversed(stolen):
                tracer.emit("steal", worker=victim, grain=g, to=thief)
        return take

    def _rebalance(self, live, queues, cost_of, est_perf, res, etas):
        """Hysteresis-gated migration of unstarted grains from the
        latest-finishing worker to the earliest-finishing one.  Each move must
        strictly reduce the fleet's max predicted finish time, so the loop
        terminates and never thrashes.  ``live``/``queues`` scope the
        decision: the whole fleet for the single coordinator, one shard's
        workers for a sharded one.  ``etas`` is the caller's bulk-computed
        finish-time prediction per live worker (``JobContext.etas_under``)."""
        if len(live) < 2:
            return
        # Inline should_replan(etas.values(), threshold): the hysteresis
        # spread gate, sans list copy — this runs on every completion.
        vals = etas.values()
        eta_hi = max(vals)
        eta_lo = min(vals)
        if not eta_hi > eta_lo * (1.0 + self.replan_threshold) + 1e-12:
            return
        tracer = self.tracer
        moved = 0
        # Move budget (total queued grains + 1) guarantees termination; it is
        # computed lazily at the first actual move since most calls pass the
        # hysteresis gate yet move nothing.
        budget = None
        while True:
            # Fused argmax-over-donors / argmin-over-live pass.  Strict
            # comparisons keep the first-occurrence tie-breaks of
            # max(donors, key=...) / min(live, key=...) — bitwise-identical
            # selection, one scan instead of three.
            hi = lo = None
            hi_e = lo_e = 0.0
            for w in live:
                e = etas[w]
                if queues[w] and (hi is None or e > hi_e):
                    hi, hi_e = w, e
                if lo is None or e < lo_e:
                    lo, lo_e = w, e
            if hi is None:
                break  # no donors
            if hi == lo:
                break
            g = queues[hi][-1]
            c = cost_of(g)
            new_lo = lo_e + c / est_perf(lo)
            if new_lo >= hi_e - _EPS:
                break  # no strict improvement left
            if budget is None:
                budget = sum(len(queues[w]) for w in live) + 1
            if moved >= budget:
                break
            queues[hi].pop()
            queues[lo].append(g)
            etas[hi] = hi_e - c / est_perf(hi)
            etas[lo] = new_lo
            moved += 1
            if tracer is not None:
                tracer.emit("migrate", worker=hi, grain=g, to=lo)
        if moved:
            res.n_replans += 1
            res.n_migrated += moved
            if tracer is not None:
                tracer.emit("rebalance", moved=moved,
                            eta_max_before=eta_hi, eta_min_before=eta_lo,
                            eta_max_after=max(etas.values()),
                            eta_min_after=min(etas.values()))

    def _rebalance_reference(self, live, queues, eta, cost_of, est_perf, res):
        """The pre-fast-path ``_rebalance``, kept verbatim as the
        ``eta_mode='recompute'`` reference: per-worker ``eta`` closure calls,
        ``should_replan`` on a list copy, eager move budget, and
        rebuilt-per-iteration donor scans with key lambdas.  Decision-
        equivalent to ``_rebalance`` (the property sweep asserts bitwise-
        identical RunReports); kept so before/after loop timings compare the
        real historical hot path, not a strawman."""
        if len(live) < 2:
            return
        etas = {w: eta(w) for w in live}
        if not should_replan(list(etas.values()), self.replan_threshold):
            return
        moved = 0
        budget = sum(len(q) for q in queues.values()) + 1
        while budget > 0:
            budget -= 1
            donors = [w for w in live if queues[w]]
            if not donors:
                break
            hi = max(donors, key=lambda w: etas[w])
            lo = min(live, key=lambda w: etas[w])
            if hi == lo:
                break
            g = queues[hi][-1]
            c = cost_of(g)
            new_lo = etas[lo] + c / est_perf(lo)
            if new_lo >= etas[hi] - _EPS:
                break  # no strict improvement left
            queues[hi].pop()
            queues[lo].append(g)
            etas[hi] -= c / est_perf(hi)
            etas[lo] = new_lo
            moved += 1
        if moved:
            res.n_replans += 1
            res.n_migrated += moved

    def _apply_timeline(self, ev: TimelineEvent, now, queues, abort_inflight,
                        dead, ctx: JobContext):
        if ev.kind in _WORKLOAD_KINDS:
            raise ValueError(
                f"timeline event {ev.kind!r} is workload-plane: it is "
                "consumed by the serving layer when materializing an "
                "ArrivalSource (FleetServer.serve_stream / Cluster.serve), "
                "not executed by the runtime"
            )
        if ev.kind in _COORD_KINDS:
            self.authority.apply_coord_event(ev, now, ctx)
            return
        if ev.kind == "perf":
            # Stale scripts (unknown or already-dead worker) are no-ops, same
            # as the kill branch below.
            if ev.worker in self.workers and ev.worker not in dead:
                self.workers[ev.worker].perf = ev.perf
            return
        if ev.kind == "join":
            worker = ev.worker
            self._register(worker, now_s=now,
                           perf_prior=ev.perf or getattr(worker, "perf", 1.0))
            dead.discard(worker.name)
            queues.setdefault(worker.name, ctx.new_queue())
            if worker.name not in ctx.live:
                ctx.live.append(worker.name)
            ctx.idle.add(worker.name)
            return
        # kill
        name = ev.worker
        if name not in self.workers or name in dead:
            return
        dead.add(name)
        # Aborted in-flight work first (it was admitted earliest), then the
        # unstarted queue; both re-home to the earliest-finishing survivor.
        orphans = abort_inflight(name) + list(queues.get(name, ()))
        # Remove from the fleet so later jobs on this runtime don't treat the
        # dead worker as alive (a stolen-grain heartbeat would silently
        # resurrect it in the tracker).  A rejoin re-registers it.
        self.workers.pop(name)
        self.tracker.mark_dead(name)
        self.authority.on_worker_kill(name, ctx)
        queues[name] = ctx.new_queue()
        if name in ctx.live:
            ctx.live.remove(name)
        ctx.idle.discard(name)
        live = ctx.live
        if not live and orphans:
            raise RuntimeError("all workers dead with grains pending")
        if ctx.pool_of is not None:
            # Orphans re-home within the dead worker's pool only.
            pool = ctx.pool_of(name)
            live = [w for w in live if ctx.pool_of(w) == pool]
            if not live and orphans:
                raise RuntimeError(
                    f"killed {name!r}, the last live {pool!r} worker, with "
                    f"{len(orphans)} {pool} grains pending — a role-"
                    "disaggregated fleet needs at least one live worker per "
                    "role"
                )
        if orphans:
            heir = self.authority.heir_for(name, live, ctx)
            queues[heir].extend(orphans)
