"""FleetServer: multi-bundle serving over a fleet of real decode engines.

The production face of the serving tier: N heterogeneous replicas (distinct
``max_batch`` slot counts and step clocks), one homogenized dispatcher, and a
workload of many requests served back-to-back with **admission control** —
each wave admits at most ``max_queue_depth`` unstarted requests per live
replica, the rest wait in the server backlog.  Bounding the per-replica queue
keeps requests runtime-side (hence migratable off a degrading replica) and
keeps one replica's death from orphaning a deep queue.

Each wave is one batched ``dispatch_to_engines`` bundle: engine slots stay
full (continuous batching), tokens/sec heartbeats are measured, and the
tracker state persists across waves, so wave k+1's allotment reflects what
wave k actually observed.  Timeline events passed to ``serve`` are relative
to its start; events landing past a wave's end carry over to the next wave
(the runtime's pending-event semantics).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Sequence

from ..core.homogenization import scope_lengths
from ..core.runtime import TimelineEvent
from ..core.scheduler import GrainPlan
from ..obs import Tracer
from .disagg import RoleStats, TTFTSplit, build_ttft_split
from .dispatch import HomogenizedDispatcher, Replica

__all__ = [
    "BundleStats",
    "FleetReport",
    "FleetServer",
    "LatencyStats",
    "RequestTrace",
    "StreamReport",
]


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample (empty -> nan)."""
    n = len(sorted_vals)
    if n == 0:
        return float("nan")
    return sorted_vals[min(n - 1, max(0, math.ceil(q * n) - 1))]


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """One request's open-loop lifecycle, in stream-relative seconds.
    A shed request has ``shed=True`` and no timing past ``arrive_s`` — the
    explicit reject record admission control owes the client."""

    rid: int
    arrive_s: float
    first_token_s: float | None      # None until a token was produced / shed
    finish_s: float | None           # None when shed
    worker: str | None
    tokens: int
    shed: bool = False

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrive_s

    @property
    def latency_s(self) -> float | None:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrive_s


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """Latency-percentile view of one open-loop stream: TTFT percentiles,
    per-token latency, goodput under a deadline, and the shed rate."""

    n_served: int
    n_shed: int
    p50_ttft_s: float
    p99_ttft_s: float
    mean_ttft_s: float
    p50_token_s: float               # total latency / tokens, per request
    p99_token_s: float
    deadline_s: float | None = None
    n_within_deadline: int = 0
    goodput_rps: float = 0.0         # deadline-met completions / sim second
    shed_rate: float = 0.0

    @classmethod
    def from_traces(
        cls,
        traces: Sequence[RequestTrace],
        sim_time_s: float,
        deadline_s: float | None = None,
    ) -> "LatencyStats":
        served = [t for t in traces if not t.shed]
        ttfts = sorted(t.ttft_s for t in served if t.ttft_s is not None)
        per_tok = sorted(
            t.latency_s / max(t.tokens, 1)
            for t in served if t.latency_s is not None
        )
        n_met = sum(
            1 for t in served
            if deadline_s is not None and t.latency_s is not None
            and t.latency_s <= deadline_s
        )
        n_shed = len(traces) - len(served)
        return cls(
            n_served=len(served),
            n_shed=n_shed,
            p50_ttft_s=_percentile(ttfts, 0.50),
            p99_ttft_s=_percentile(ttfts, 0.99),
            mean_ttft_s=sum(ttfts) / len(ttfts) if ttfts else float("nan"),
            p50_token_s=_percentile(per_tok, 0.50),
            p99_token_s=_percentile(per_tok, 0.99),
            deadline_s=deadline_s,
            n_within_deadline=n_met,
            goodput_rps=(
                n_met / max(sim_time_s, 1e-12)
                if deadline_s is not None else 0.0
            ),
            shed_rate=n_shed / max(len(traces), 1),
        )


@dataclasses.dataclass(frozen=True)
class BundleStats:
    """One wave: how many requests, how many measured output tokens, and how
    well the replicas crossed the homogenization line.  ``worker_busy`` /
    ``worker_finish`` (wave-relative seconds) feed the unified
    ``cluster.RunReport`` per-worker timelines."""

    n_requests: int
    tokens_out: int
    sim_time_s: float
    tokens_per_s: float
    quality: float
    n_migrated: int
    shares: dict[str, int]
    worker_busy: dict[str, float] = dataclasses.field(default_factory=dict)
    worker_finish: dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """Aggregate serving result.  As a *user-facing* result type this is
    superseded by ``repro.cluster.RunReport`` (``Cluster.serve`` wraps it);
    it remains the serving tier's internal report."""

    bundles: tuple[BundleStats, ...]
    n_requests: int
    tokens_out: int
    sim_time_s: float          # waves run back-to-back: sum of makespans
    tokens_per_s: float
    worst_quality: float


@dataclasses.dataclass(frozen=True)
class StreamReport:
    """One open-loop stream: continuous admission, per-request latency
    traces, and any replicas the autoscaler joined mid-stream."""

    n_requests: int
    n_served: int
    n_shed: int
    tokens_out: int
    sim_time_s: float
    tokens_per_s: float
    quality: float             # survivor drain-time spread at stream end
    n_migrated: int
    shares: dict[str, int]
    traces: tuple[RequestTrace, ...]
    latency: LatencyStats
    joined: tuple[str, ...] = ()
    worker_busy: dict[str, float] = dataclasses.field(default_factory=dict)
    worker_finish: dict[str, float] = dataclasses.field(default_factory=dict)
    # Disaggregated streams only (None/empty on mixed-role fleets):
    ttft_split: TTFTSplit | None = None
    role_stats: tuple[RoleStats, ...] = ()
    n_handoffs: int = 0

    @property
    def shed_rate(self) -> float:
        return self.n_shed / max(self.n_requests, 1)


class FleetServer:
    """Admission-controlled serving of arbitrarily large workloads.

    ``replicas[i].perf`` is the replica's step clock (engine steps per
    simulated second); ``engines[name]`` backs each replica with a
    ``DecodeEngine`` (or duck-typed equivalent).  One FleetServer owns one
    dispatcher/tracker, so learned perfs persist across ``serve`` calls.
    """

    def __init__(
        self,
        replicas: Sequence[Replica],
        engines: dict[str, object],
        *,
        max_queue_depth: int = 8,
        homogenize: bool = True,
        alpha: float = 0.5,
        engine_factory=None,
        authority=None,
        backend=None,
        eta_mode: str | None = None,
        tracer=None,
    ):
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        missing = {r.name for r in replicas} - set(engines)
        if missing and engine_factory is None:
            raise ValueError(f"replicas without engines {sorted(missing)}")
        self.dispatcher = HomogenizedDispatcher(
            replicas, homogenize=homogenize, alpha=alpha, authority=authority,
            backend=backend, eta_mode=eta_mode, tracer=tracer,
        )
        self.engines = dict(engines)
        self.max_queue_depth = max_queue_depth
        # ``engine_factory(worker) -> engine`` backs replicas that join the
        # fleet without one (mid-wave Scenario joins, between-wave rejoins):
        # the engine is built on demand and registered, so a joined
        # WorkerSpec always brings (or lazily constructs) its engine before
        # admission — the ROADMAP join fix.
        self.engine_factory = engine_factory

    @property
    def tracker(self):
        return self.dispatcher.tracker

    def live_replicas(self) -> list[str]:
        if self.engine_factory is not None:
            return list(self.tracker.workers())
        return [n for n in self.tracker.workers() if n in self.engines]

    def _factory(self, worker):
        """Wrap the user factory so lazily-built engines are registered on
        the server (later waves must reuse them, not rebuild)."""
        eng = self.engine_factory(worker)
        self.engines[worker.name] = eng
        return eng

    def serve(
        self,
        requests: Sequence,
        timeline: tuple[TimelineEvent, ...] = (),
        batched: bool = True,
        timeline_fn=None,
    ) -> FleetReport:
        """Serve ``requests`` in admission-controlled waves; returns per-wave
        and aggregate measured throughput.  ``batched=False`` routes every
        wave through the per-request-serial baseline instead (same admission
        control, no slot-level batching) — the benchmark's comparison axis.

        ``timeline_fn(wave_idx) -> events`` is the *wave-start callback*
        form: called as each wave actually begins, returning that wave's
        events with times relative to the wave start — so phase-anchored
        scenarios (``ScenarioSchedule``) see true wave boundaries instead of
        plan-based estimates.  Mutually exclusive with ``timeline``."""
        if timeline_fn is not None and timeline:
            raise ValueError("pass either timeline or timeline_fn, not both")
        backlog = deque(requests)
        bundles: list[BundleStats] = []
        first = True
        wave_idx = 0
        while backlog:
            live = self.live_replicas()
            if not live:
                raise RuntimeError(
                    f"no live replicas; {len(backlog)} requests stranded"
                )
            quota = self.max_queue_depth * len(live)
            wave = [backlog.popleft() for _ in range(min(quota, len(backlog)))]
            if timeline_fn is not None:
                wave_timeline = tuple(timeline_fn(wave_idx))
            else:
                wave_timeline = timeline if first else ()
            res, run = self.dispatcher.dispatch_to_engines(
                {n: self.engines[n] for n in live if n in self.engines},
                wave,
                timeline=wave_timeline,
                batched=batched,
                engine_factory=(
                    self._factory if self.engine_factory is not None else None
                ),
                initial_plan=self._wave_plan(len(wave)),
            )
            first = False
            wave_idx += 1
            tokens = sum(len(r.out_tokens) for r in wave)
            wave_start = run.end_s - run.makespan if run is not None else 0.0
            bundles.append(BundleStats(
                n_requests=len(wave),
                tokens_out=tokens,
                sim_time_s=res.makespan,
                tokens_per_s=tokens / max(res.makespan, 1e-12),
                quality=res.quality,
                n_migrated=res.n_migrated,
                shares=res.shares,
                worker_busy=dict(run.worker_busy) if run is not None else {},
                worker_finish={
                    w: f - wave_start for w, f in run.worker_finish.items()
                } if run is not None else {},
            ))
        total_tokens = sum(b.tokens_out for b in bundles)
        total_time = sum(b.sim_time_s for b in bundles)
        return FleetReport(
            bundles=tuple(bundles),
            n_requests=sum(b.n_requests for b in bundles),
            tokens_out=total_tokens,
            sim_time_s=total_time,
            tokens_per_s=total_tokens / max(total_time, 1e-12),
            worst_quality=max((b.quality for b in bundles), default=1.0),
        )

    def _wave_plan(self, n: int) -> GrainPlan | None:
        """Per-replica admission enforcement for one wave: the homogenized
        allotment, with every replica's initial queue capped at
        ``max_queue_depth``.  The old quota was *global* (depth x live
        count), so a fast replica could be handed another replica's share of
        the wave and start it depth-deep — exactly the unbounded-queue risk
        admission control exists to prevent.  Returns None when no cap binds,
        which keeps the uncapped path (and its plans) bitwise-identical."""
        plan = self.dispatcher.runtime.plan(n)
        cap = self.max_queue_depth
        if all(s <= cap for s in plan.shares):
            return None
        now = self.dispatcher.clock
        capped: dict[str, int] = {}
        free = dict(zip(plan.workers, plan.shares))
        while True:
            over = {w: s for w, s in free.items() if s > cap}
            if not over:
                break
            excess = sum(s - cap for s in over.values())
            for w in over:
                capped[w] = cap
                free.pop(w)
            if not free:
                # n <= cap * n_live (the wave quota), so nothing is left over
                # once everyone sits at the cap.
                break
            names = list(free)
            add = scope_lengths(
                excess, [self.tracker.perf(w, now) for w in names]
            )
            for w, a in zip(names, add):
                free[w] += a
        shares = {**capped, **free}
        return GrainPlan(
            workers=plan.workers,
            shares=tuple(shares[w] for w in plan.workers),
            total_grains=n,
        )

    def serve_stream(
        self,
        requests: Sequence,
        arrive_s: Sequence[float],
        *,
        timeline: tuple[TimelineEvent, ...] = (),
        overflow: str = "queue",
        deadline_s: float | None = None,
        scale_rules: Sequence = (),
        scale_worker=None,
        roles: dict[str, str] | None = None,
    ) -> StreamReport:
        """Open-loop continuous serving: request ``i`` arrives ``arrive_s[i]``
        seconds into the stream and is admitted to the min-ETA replica with
        queue room (per-replica ``max_queue_depth``); arrivals finding every
        queue full are backlogged (``overflow='queue'``) or shed with a
        reject trace (``overflow='shed'``).  Per-request enqueue /
        first-token / completion timestamps land in ``StreamReport.traces``
        and roll up into ``LatencyStats`` (p50/p99 TTFT, per-token latency,
        goodput under ``deadline_s``, shed rate).

        ``scale_rules`` close the metrics->membership loop: each rule (duck
        type: ``add``, ``metric`` 'p50'|'p99', ``threshold`` seconds,
        ``window`` samples) watches a rolling TTFT window as decodes finish
        and, on breach, joins ``add`` new replicas mid-stream through the
        engine-factory path.  ``scale_worker(i)`` builds the i-th joined
        replica (default: a clone of the fastest live replica's step clock,
        named ``scale{i}``).

        ``roles`` (replica name -> 'prefill'|'decode') routes the stream
        through the disaggregated plane: requests prefill on the prefill
        pool (bucketed one-call prefill), hand their KV off to the decode
        pool, and the report carries the TTFT split and per-role quality."""
        requests = list(requests)
        arrive = [float(t) for t in arrive_s]
        if len(arrive) != len(requests):
            raise ValueError(
                f"arrive_s covers {len(arrive)} requests, got {len(requests)}"
            )
        if roles and scale_rules:
            raise ValueError(
                "scale: rules cannot target a role-disaggregated fleet — a "
                "joined replica's role is ambiguous; pre-provision the pool "
                "in the fleet spec instead (e.g. 'fast=2^prefill*2')"
            )
        if scale_rules and self.engine_factory is None:
            raise ValueError(
                "scale rules join new replicas mid-stream, which needs an "
                "engine_factory to build their engines; construct the "
                "FleetServer with engine_factory= (or drop the scale: clause)"
            )
        live = self.live_replicas()
        if not live:
            raise RuntimeError(
                f"no live replicas; {len(requests)} requests stranded"
            )

        rt = self.dispatcher.runtime
        start = rt.clock
        # Per-request TTFT/completion accounting rides the obs event
        # vocabulary: first_token / ttft_drop events from the executor and
        # complete events from the runtime fold back into RequestTraces
        # below.  With no caller-supplied tracer an ephemeral one carries the
        # events for just this stream — same values the executor dict held,
        # so LatencyStats output is byte-identical either way.
        ephemeral = rt.tracer is None
        if ephemeral:
            rt.tracer = Tracer()
        stream_tracer = rt.tracer
        ev_mark = len(stream_tracer.events)
        joined: list[str] = []
        fired = [False] * len(scale_rules)
        ttfts: deque[float] = deque(
            maxlen=max((r.window for r in scale_rules), default=1)
        )

        def default_scale_worker(i: int) -> Replica:
            fastest = max(self.dispatcher.replicas.values(),
                          key=lambda r: r.perf)
            return Replica(f"scale{i}", fastest.perf)

        def on_finish(g, req, wname, now_s, first_token_s):
            ttfts.append(first_token_s - (start + arrive[g]))
            for i, rule in enumerate(scale_rules):
                if fired[i] or len(ttfts) < rule.window:
                    continue
                vals = sorted(list(ttfts)[-rule.window:])
                q = float(rule.metric[1:]) / 100.0
                if _percentile(vals, q) <= rule.threshold:
                    continue
                fired[i] = True
                pv = self.tracker.perf_vector()
                for _ in range(rule.add):
                    rep = (scale_worker or default_scale_worker)(len(joined))
                    # Prior: the best learned effective rate, so the joiner
                    # is offered real work immediately instead of ramping a
                    # neutral 1.0 through heartbeats.
                    prior = max(pv.values(), default=rep.perf)
                    rt.inject_event(
                        TimelineEvent(now_s, "join", rep, perf=prior)
                    )
                    joined.append(rep.name)

        try:
            res, run, executor = self.dispatcher.dispatch_stream(
                {n: self.engines[n] for n in live if n in self.engines},
                requests,
                arrive,
                timeline=timeline,
                max_queue_depth=self.max_queue_depth,
                overflow=overflow,
                engine_factory=(
                    self._factory if self.engine_factory is not None else None
                ),
                on_finish=on_finish,
                roles=roles,
            )
        finally:
            if ephemeral:
                rt.tracer = None

        # Fold this stream's trace events back into per-request accounting:
        # the last surviving first_token sets TTFT (a ttft_drop — cancelled
        # mixed-path decode — voids it, exactly as the executor dict's
        # pop-on-abort did), and each grain's single complete event carries
        # its completion time and executing worker.
        ft_s: dict[int, float] = {}
        done: dict[int, tuple[float, str]] = {}
        for e in stream_tracer.events[ev_mark:]:
            if e.kind == "complete":
                done[e.grain] = (e.t_s, e.worker)
            elif e.kind == "first_token":
                ft_s[e.grain] = e.t_s
            elif e.kind == "ttft_drop":
                ft_s.pop(e.grain, None)

        # Disaggregated streams complete on the *decode* grain (request g's
        # completion record is grain n + g); mixed streams on grain g.
        off = len(requests) if roles else 0
        shed = {g for g in run.shed if g < len(requests)}
        traces = []
        for g, r in enumerate(requests):
            if g in shed:
                traces.append(RequestTrace(
                    r.rid, arrive[g], None, None, None, 0, shed=True))
                continue
            ft = ft_s.get(g)
            end_s, served_by = done[off + g]
            traces.append(RequestTrace(
                r.rid, arrive[g],
                None if ft is None else ft - start,
                end_s - start,
                served_by,
                len(r.out_tokens),
            ))
        tokens = sum(t.tokens for t in traces)
        stream_start = run.end_s - run.makespan

        ttft_split: TTFTSplit | None = None
        role_stats: tuple[RoleStats, ...] = ()
        n_handoffs = 0
        if roles:
            rel_arrive = [start + a for a in arrive]
            finish = {g: done[off + g][0] for g in range(len(requests))
                      if off + g in done}
            ttft_split = build_ttft_split(executor, rel_arrive, finish)
            counts = run.shares()
            role_stats = tuple(
                RoleStats(
                    role=role,
                    workers=tuple(members),
                    quality=run.homogenization_quality(
                        [w for w in members if w not in run.dead_workers]
                    ),
                    shares={w: counts.get(w, 0) for w in members},
                )
                for role, members in (
                    (rl, sorted(w for w, r in roles.items() if r == rl))
                    for rl in ("prefill", "decode")
                )
            )
            n_handoffs = executor.n_handoffs

        return StreamReport(
            n_requests=len(requests),
            n_served=len(requests) - len(shed),
            n_shed=len(shed),
            tokens_out=tokens,
            sim_time_s=run.makespan,
            tokens_per_s=tokens / max(run.makespan, 1e-12),
            quality=res.quality,
            n_migrated=run.n_migrated,
            shares=res.shares,
            traces=tuple(traces),
            latency=LatencyStats.from_traces(
                traces, run.makespan, deadline_s=deadline_s),
            joined=tuple(joined),
            worker_busy=dict(run.worker_busy),
            worker_finish={
                w: f - stream_start for w, f in run.worker_finish.items()
            },
            ttft_split=ttft_split,
            role_stats=role_stats,
            n_handoffs=n_handoffs,
        )

    # -- fleet management (between waves) ------------------------------------
    def degrade(self, name: str, perf: float) -> None:
        self.dispatcher.degrade(name, perf)

    def kill(self, name: str) -> None:
        self.dispatcher.kill(name)

    def rejoin(self, replica: Replica, engine: object,
               perf_prior: float | None = None) -> None:
        """Bring a (new or previously killed) replica into the fleet with its
        backing engine — the explicit path back after sticky death."""
        if engine.active or engine.queue:
            raise ValueError(f"engine for {replica.name!r} is not idle")
        self.engines[replica.name] = engine
        self.dispatcher.runtime.add_worker(replica, perf_prior=perf_prior)
        self.dispatcher._sync_replicas()
