"""EngineExecutor: continuous-batching engines as first-class runtime executors.

The serial real-execution path ran one request per grain and drained the
engine at grain-completion time, so an engine's ``max_batch`` slots never
held more than one live request and engine compute never overlapped
dispatch.  This executor plugs a fleet of ``DecodeEngine`` replicas into the
async runtime's *incremental* seam instead:

  - each replica holds up to ``max_batch`` grains in flight (its slots): the
    runtime admits a replica's assigned requests as a bundle and keeps the
    slots topped up as sequences finish (continuous batching),
  - the runtime fires one *tick* per engine step; a tick advances every
    active slot one token, so slot-level batching and cross-replica dispatch
    interleave instead of draining serially,
  - a replica's ``perf`` is its *step clock* (engine steps per simulated
    second); grain durations are measured step counts on that clock, not a
    cost model,
  - heartbeats are the engine's own measured tokens/sec
    (``DecodeEngine.heartbeat``), so the tracker learns *effective*
    throughput — batching efficiency included — and scope-length allotment
    follows real engine speed,
  - unstarted requests live in runtime-side queues and migrate off degrading
    replicas; a killed replica's admitted requests are withdrawn via
    ``DecodeEngine.cancel`` (decode state reset) and re-decoded from scratch
    on the heir — exactly-once per *completed* decode.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from ..core.performance import PerfReport
from ..core.runtime import GrainExecutor

__all__ = ["EngineExecutor"]

_EPS = 1e-12


class EngineExecutor(GrainExecutor):
    """One serving bundle: ``requests[g]`` is grain ``g``; workers are
    replicas backed by the same-named engines.

    ``engines`` may hold any object with the ``DecodeEngine`` duck type
    (``max_batch``/``max_seq``/``queue``/``active``/``submit``/``step``/
    ``heartbeat``/``cancel``) — tests drive the same executor with a
    model-free stub engine at timing scale.

    ``engine_factory`` closes the ROADMAP join gap: a replica that joins
    *mid-bundle* via a timeline event has no engine yet, and used to fail at
    ``begin``.  With a factory, the executor lazily constructs (and
    validates) the joining replica's engine on first admission, so a
    ``WorkerSpec`` joined through a ``Scenario`` brings its engine with it.
    """

    incremental = True
    uniform_cost = None
    # Optional measured step clock: ``step_clock(worker) -> seconds/step``.
    # A wall-clock backend wires this to its per-worker tick EMA so
    # heartbeats report *measured* tokens/sec instead of the modeled
    # ``1 / perf`` profile.  None keeps the modeled clock.
    step_clock = None
    # Serve-plane tracing (obs.Tracer), set by the dispatcher: first_token /
    # ttft_drop / request_done events are *the* carrier for per-request
    # latency — serve_stream folds them back into RequestTraces.
    tracer = None

    def __init__(self, engines: Mapping[str, object], requests: Sequence,
                 engine_factory=None, on_finish=None):
        self.engines = dict(engines)
        self.engine_factory = engine_factory
        self.requests = list(requests)
        # Streaming observability: grain -> simulated time of its first
        # output token (TTFT numerator).  A cancelled decode's entry is
        # dropped — the discarded tokens were never delivered, so TTFT is
        # measured on the surviving (exactly-once) decode.
        self.first_token_s: dict[int, float] = {}
        self._watch: dict[str, set[int]] = {}
        # on_finish(grain, request, worker_name, now_s, first_token_s):
        # fires at each completed decode, inside the tick — the hook a
        # reactive controller (SLO autoscaler) uses to observe latency while
        # the job runs.
        self.on_finish = on_finish
        rids = [r.rid for r in self.requests]
        if len(set(rids)) != len(rids):
            raise ValueError("request rids must be unique within a bundle")
        self._grain_of = {r.rid: g for g, r in enumerate(self.requests)}
        # Mid-bundle migration can land any request on any replica, so every
        # request must fit the smallest engine (lazily-built ones included).
        self._max_positions = max(
            (len(r.prompt) + r.max_new_tokens for r in self.requests),
            default=0,
        )
        max_fit = min(
            (eng.max_seq for eng in self.engines.values()), default=0
        )
        if self.engines and self._max_positions > max_fit:
            worst = max(self.requests,
                        key=lambda r: len(r.prompt) + r.max_new_tokens)
            raise ValueError(
                f"request {worst.rid} needs {self._max_positions}"
                f" positions; smallest engine max_seq is {max_fit}"
            )
        for name, eng in self.engines.items():
            self._validate_engine(name, eng)

    def _validate_engine(self, name: str, eng) -> None:
        if eng.active or eng.queue:
            raise ValueError(
                f"engine {name!r} is not idle; one bundle per fleet at a time"
            )
        if eng.name != name:
            # Heartbeats carry eng.name; a mismatch would teach the
            # tracker a phantom worker and starve the real replica.
            raise ValueError(
                f"engine for replica {name!r} reports as {eng.name!r}"
            )
        if self._max_positions > eng.max_seq:
            raise ValueError(
                f"engine {name!r} max_seq {eng.max_seq} cannot hold this "
                f"bundle's largest request ({self._max_positions} positions)"
            )

    def engine_for(self, worker):
        """The worker's engine, lazily built for mid-bundle joiners."""
        eng = self.engines.get(worker.name)
        if eng is None:
            if self.engine_factory is None:
                raise KeyError(
                    f"replica {worker.name!r} has no engine and the bundle "
                    "has no engine_factory to build one (mid-bundle joins "
                    "need a factory)"
                )
            eng = self.engine_factory(worker)
            self._validate_engine(worker.name, eng)
            self.engines[worker.name] = eng
        return eng

    # -- cost model (drives allotment + ETAs; execution itself is measured) --
    def cost(self, grain: int) -> float:
        r = self.requests[grain]
        return float(len(r.prompt) + r.max_new_tokens)

    def remaining_cost(self, worker, grain: int) -> float:
        r = self.requests[grain]
        fed = len(r.prompt) if r.out_tokens else 0
        return max(1.0, self.cost(grain) - fed - len(r.out_tokens))

    # -- incremental seam ----------------------------------------------------
    def concurrency(self, worker) -> int:
        return self.engine_for(worker).max_batch

    def step_seconds(self, worker) -> float:
        """Seconds per engine step: the replica's modeled speed profile, or
        the backend's measured clock when ``step_clock`` is wired."""
        if self.step_clock is not None:
            return self.step_clock(worker)
        return 1.0 / max(worker.perf, _EPS)

    def tick_s(self, worker, now_s: float) -> float:
        return self.step_seconds(worker)

    def begin(self, worker, grain: int, now_s: float) -> None:
        self.engine_for(worker).submit(self.requests[grain])
        self._watch.setdefault(worker.name, set()).add(grain)

    def tick(self, worker, now_s: float) -> list[tuple[int, object]]:
        finished = self.engines[worker.name].step()
        watch = self._watch.get(worker.name)
        tracer = self.tracer
        if watch:
            for g in [g for g in watch if self.requests[g].out_tokens]:
                self.first_token_s[g] = now_s
                watch.discard(g)
                if tracer is not None:
                    tracer.emit("first_token", t_s=now_s, worker=worker.name,
                                grain=g)
        out = [(self._grain_of[r.rid], r) for r in finished]
        if self.on_finish is not None:
            for g, r in out:
                self.on_finish(g, r, worker.name, now_s,
                               self.first_token_s.get(g, now_s))
        if tracer is not None:
            for g, r in out:
                tracer.emit("request_done", t_s=now_s, worker=worker.name,
                            grain=g, rid=r.rid, tokens=len(r.out_tokens))
        return out

    def abort(self, worker, grain: int) -> None:
        self.engines[worker.name].cancel(self.requests[grain].rid)
        self._watch.get(worker.name, set()).discard(grain)
        had_ft = self.first_token_s.pop(grain, None)
        if had_ft is not None and self.tracer is not None:
            # The cancelled decode's tokens were never delivered: its TTFT
            # sample dies with it (the surviving re-decode re-measures).
            self.tracer.emit("ttft_drop", worker=worker.name, grain=grain)

    def heartbeat(self, worker, now_s: float) -> PerfReport | None:
        return self.engines[worker.name].heartbeat(
            now_s, seconds_per_step=self.step_seconds(worker)
        )
