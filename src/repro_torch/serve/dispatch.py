"""Homogenized request dispatch across serving replicas.

The paper's scope-length allotment applied at the serving tier: replicas are
service-providers, a request bundle is the linearly-divisible load, and the
dispatcher (TDA server) assigns each replica a share proportional to its
homogenized performance (EMA of measured tokens/sec heartbeats).  Dispatch
rides the async event-loop runtime (``core/runtime.py``): every request
completion is a heartbeat, and unstarted requests migrate off stragglers
mid-bundle — so all replicas drain their queues at the same moment (the
homogenization line) even when a replica degrades *during* the bundle.

``dispatch_to_engines`` drives *real* ``DecodeEngine`` replicas.  The default
**batched** path plugs the engines into the runtime's incremental seam via
``EngineExecutor``: every replica keeps its ``max_batch`` slots full, grain
durations are measured engine-step counts on the replica's step clock, and
heartbeats are the engines' own measured tokens/sec.  ``batched=False`` keeps
the per-request-serial baseline (one request per grain, engine drained at
completion time, modeled timing) for comparison — ``benchmarks/bench_serve.py``
quantifies the gap.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.performance import PerformanceTracker
from ..core.runtime import (
    AsyncRuntime,
    ExecutionBackend,
    RuntimeResult,
    SimBackend,
    TimelineEvent,
)
from .disagg import DisaggExecutor
from .executor import EngineExecutor

__all__ = ["Replica", "DispatchResult", "HomogenizedDispatcher"]


@dataclasses.dataclass
class Replica:
    name: str
    perf: float            # true speed, hidden from the scheduler (learned
                           # via heartbeats): tokens/sec for simulated
                           # bundles, engine steps/sec for the batched
                           # real-engine path


@dataclasses.dataclass(frozen=True)
class DispatchResult:
    shares: dict[str, int]
    makespan: float        # simulated: max replica drain time
    per_replica_time: dict[str, float]
    n_migrated: int = 0    # requests re-homogenized/stolen mid-bundle
    quality: float = 1.0   # drain-time spread (1.0 = homogenization line)


class HomogenizedDispatcher:
    def __init__(self, replicas: Sequence[Replica], homogenize: bool = True,
                 alpha: float = 0.5, authority=None, backend=None,
                 eta_mode: str | None = None, tracer=None):
        self.replicas = {r.name: r for r in replicas}
        self.homogenize = homogenize
        self.tracker = PerformanceTracker(alpha=alpha, dead_after_s=1e9)
        # ``authority`` shards the dispatch plane (coord.ShardedCoordinator);
        # None keeps the single-coordinator default.  ``backend`` swaps tick
        # timing: None keeps the modeled step clock; a measuring
        # ExecutionBackend times each engine step for real and its
        # ``step_clock`` feeds measured seconds/step into heartbeats.
        # ``tracer`` (obs.Tracer) observes the dispatch plane; serve_stream
        # may also attach one per stream via ``runtime.tracer``.
        self.runtime = AsyncRuntime(
            list(replicas),
            tracker=self.tracker,
            homogenize=homogenize,
            rehomogenize=homogenize,
            steal=homogenize,
            authority=authority,
            eta_mode=eta_mode,
            backend=backend,
            tracer=tracer,
        )
        measured = backend is not None and type(backend) not in (
            SimBackend, ExecutionBackend
        )
        self._step_clock = getattr(backend, "step_clock", None) if measured \
            else None

    @property
    def clock(self) -> float:
        return self.runtime.clock

    def _sync_replicas(self) -> None:
        """Mirror the runtime's live fleet: timeline kills drop replicas,
        timeline joins add them — ``self.replicas`` is never stale."""
        self.replicas = dict(self.runtime.workers)

    def _result(self, run: RuntimeResult) -> DispatchResult:
        names = self.tracker.workers()
        counts = run.shares()
        return DispatchResult(
            shares={n: counts.get(n, 0) for n in names},
            makespan=run.makespan,
            per_replica_time={n: run.worker_busy.get(n, 0.0) for n in names},
            n_migrated=run.n_migrated,
            quality=run.homogenization_quality(names),
        )

    def dispatch(
        self,
        n_requests: int,
        tokens_per_request: float = 1.0,
        timeline: tuple[TimelineEvent, ...] = (),
        execute=None,
    ) -> DispatchResult:
        """Dispatch a bundle of ``n_requests`` through the runtime.

        ``timeline`` events use times relative to the start of this bundle
        (mid-bundle degradation/death scenarios).  ``execute(replica, i)``
        optionally runs real per-request work at completion time."""
        run = self.runtime.run(
            n_requests,
            grain_cost=tokens_per_request,
            timeline=timeline,
            timeline_relative=True,
            execute=execute,
        )
        self._sync_replicas()
        return self._result(run)

    def dispatch_stream(
        self,
        engines: dict[str, object],
        requests: list,
        arrive_s,
        *,
        timeline: tuple[TimelineEvent, ...] = (),
        max_queue_depth: int | None = None,
        overflow: str = "queue",
        engine_factory=None,
        on_finish=None,
        roles: dict[str, str] | None = None,
    ) -> tuple[DispatchResult, RuntimeResult, EngineExecutor | DisaggExecutor]:
        """Open-loop real-execution path: requests *arrive* at job-relative
        times ``arrive_s[i]`` instead of being planned up front.  Each arrival
        is admitted to the min-ETA replica with queue room
        (``max_queue_depth``); saturation queues or sheds per ``overflow``
        (``RuntimeResult.shed``).  Always batched — continuous open-loop
        admission is only meaningful against live engine slots.  Returns the
        executor too, so callers can read per-grain first-token times.

        ``roles`` (replica name -> 'prefill'|'decode') switches the stream to
        the disaggregated plane: each request becomes a prefill grain plus a
        *deferred* decode grain (its KV handoff), pools are homogenized
        independently, and arrivals are admitted prefill-first."""
        self._validate_engines(engines, engine_factory)
        if roles:
            executor = DisaggExecutor(engines, requests, roles,
                                      engine_factory=engine_factory,
                                      on_finish=on_finish)
            executor.step_clock = self._step_clock
            executor.tracer = self.runtime.tracer
            run = self.runtime.run(
                2 * len(requests),
                executor=executor,
                timeline=timeline, timeline_relative=True,
                arrivals=[float(t) for t in arrive_s],
                n_deferred=len(requests),
                max_queue_depth=max_queue_depth,
                overflow=overflow,
            )
            self._sync_replicas()
            return self._result(run), run, executor
        executor = EngineExecutor(engines, requests,
                                  engine_factory=engine_factory,
                                  on_finish=on_finish)
        executor.step_clock = self._step_clock
        executor.tracer = self.runtime.tracer
        run = self.runtime.run(
            len(requests),
            executor=executor,
            timeline=timeline, timeline_relative=True,
            arrivals=[float(t) for t in arrive_s],
            max_queue_depth=max_queue_depth,
            overflow=overflow,
        )
        self._sync_replicas()
        return self._result(run), run, executor

    def _validate_engines(self, engines: dict[str, object],
                          engine_factory) -> None:
        unknown = set(engines) - set(self.replicas)
        if unknown:
            raise ValueError(f"engines for unknown replicas {sorted(unknown)}")
        unbacked = set(self.tracker.workers()) - set(engines)
        if unbacked and engine_factory is None:
            # A live replica with no engine would be scheduled grains it
            # cannot execute (KeyError mid-bundle after partial decode).
            raise ValueError(f"live replicas without engines {sorted(unbacked)}")

    def dispatch_to_engines(
        self,
        engines: dict[str, object],
        requests: list,
        timeline: tuple[TimelineEvent, ...] = (),
        batched: bool = True,
        engine_factory=None,
        initial_plan=None,
    ) -> tuple[DispatchResult, RuntimeResult | None]:
        """Real-execution path: route ``requests`` (serve.engine.Request) to
        named DecodeEngines via the runtime.

        ``batched=True`` (default): engines are incremental executors — a
        replica's assigned requests are admitted into its slots as a bundle,
        each runtime tick is one engine step, durations and tokens/sec
        heartbeats are *measured* on the replica's step clock.

        ``batched=False``: per-request-serial baseline — a request costs
        prompt+max_new tokens, each engine drains one request at completion
        time, timing comes from the simulated replica perfs.

        Either way every request is decoded exactly once, even when it
        migrates between replica queues (or off a killed replica) mid-bundle.
        ``engine_factory(worker)`` backs replicas that join mid-bundle (or
        arrive live-but-engineless) by building their engine on demand.
        ``initial_plan`` overrides the tracker-derived allotment (the fleet
        layer's per-replica admission caps).
        """
        self._validate_engines(engines, engine_factory)

        if batched:
            executor = EngineExecutor(engines, requests,
                                      engine_factory=engine_factory)
            executor.step_clock = self._step_clock
            run = self.runtime.run(
                len(requests),
                executor=executor,
                timeline=timeline, timeline_relative=True,
                initial_plan=initial_plan,
            )
            self._sync_replicas()
            return self._result(run), run

        def engine_of(replica):
            eng = engines.get(replica.name)
            if eng is None:
                if engine_factory is None:
                    raise KeyError(f"replica {replica.name!r} has no engine")
                eng = engines[replica.name] = engine_factory(replica)
            return eng

        def execute(replica, i):
            eng = engine_of(replica)
            req = requests[i]
            eng.submit(req)
            done = eng.run_until_drained()
            return done[-1] if done else None

        def cost(i):
            return float(len(requests[i].prompt) + requests[i].max_new_tokens)

        run = self.runtime.run(
            len(requests), grain_cost=cost, execute=execute,
            timeline=timeline, timeline_relative=True,
            initial_plan=initial_plan,
        )
        self._sync_replicas()
        return self._result(run), run

    def degrade(self, name: str, perf: float) -> None:
        """True-perf shift outside a bundle (the tracker learns it from the
        next bundle's heartbeats).  Consistent with sticky death: degrading
        an unknown or dead replica fails loudly instead of silently mutating
        a ghost."""
        if name not in self.replicas:
            raise KeyError(
                f"unknown or dead replica {name!r} (kills are sticky; "
                "rejoin it first)"
            )
        self.replicas[name].perf = perf

    def kill(self, name: str) -> None:
        """Between-bundle kill: drop the replica from the fleet *and* from
        ``self.replicas`` (sticky-death semantics — the tracker rejects any
        late heartbeat, and ``degrade`` on the name now raises)."""
        if name not in self.replicas:
            raise KeyError(f"unknown replica {name!r}")
        self.replicas.pop(name)
        self.runtime.remove_worker(name)
