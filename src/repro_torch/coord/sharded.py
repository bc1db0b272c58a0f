"""ShardedCoordinator: the TDA's dispatch authority, split across K replicas.

The paper's TDA is a single dispatch authority — one host ingests every
heartbeat, re-homogenizes every queue, and therefore caps fleet size at one
host's event rate.  This module decentralizes it while keeping the
homogenization-quality invariant:

  - **sharding**: workers map to K logical coordinator shards by rendezvous
    (highest-random-weight) hashing — consistent, so the same worker lands on
    the same shard across jobs and restarts, and a membership change moves
    only the affected workers,
  - **local authority**: each shard ingests its own workers' heartbeats and
    runs the hysteresis-gated re-homogenization / stealing discipline of
    ``core/runtime.py`` *within its shard*, using its private ``PerfView``,
  - **gossip**: shards exchange perf-vector deltas on the deterministic
    round-based ``GossipBus`` (staleness-aware merge), so every shard
    converges on the fleet-wide perf view within ``ceil(log2 K)`` rounds,
  - **cross-shard stealing**: a shard whose local queues drain pulls the tail
    of the worst remote queue, split proportionally to *gossiped* perf and
    gated by the same ``should_replan`` hysteresis,
  - **coordinator faults**: a ``ckill`` timeline event kills a shard; its
    workers, queues and in-flight bookkeeping are adopted wholesale by the
    ring successor (grains never re-execute — the workers keep computing,
    only the authority over them moves).  ``partition``/``heal`` split and
    restore gossip/steal connectivity.

Dispatch throughput is modeled by event accounting: every event a shard
handles (grain completion, engine tick, timeline change, gossip message,
steal negotiation) costs ``event_cost_s`` of coordinator time, so the
achievable event rate is ``total_events / (max_shard_events * event_cost_s)``
— the quantity ``benchmarks/bench_coord.py`` shows scaling with K.
"""

from __future__ import annotations

import dataclasses
import zlib

from ..core.performance import PerfReport
from ..core.runtime import DispatchAuthority, JobContext, TimelineEvent
from ..core.scheduler import should_replan
from .gossip import GossipBus

__all__ = ["CoordSpec", "CoordStats", "ShardedCoordinator", "rendezvous_shard"]

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class CoordSpec:
    """Declarative coordination-plane shape: how many coordinator replicas,
    how chatty the gossip, and what one dispatch event costs a coordinator
    (the modeled per-event handling time the throughput numbers are built
    on).  ``period_s=None`` derives a per-job period targeting ~16 gossip
    rounds per job."""

    coordinators: int = 1
    fanout: int = 1
    period_s: float | None = None
    event_cost_s: float = 1e-4

    def __post_init__(self):
        if self.coordinators < 1:
            raise ValueError("coordinators must be >= 1")
        if self.fanout < 1:
            raise ValueError("gossip fanout must be >= 1")
        if self.period_s is not None and self.period_s <= 0:
            raise ValueError("gossip period must be > 0")
        if self.event_cost_s <= 0:
            raise ValueError("event_cost_s must be > 0")


@dataclasses.dataclass(frozen=True)
class CoordStats:
    """Coordination-plane execution record (rides on RuntimeResult.coord and
    RunReport.coord).  Event counts are cumulative over the authority's
    lifetime; staleness is measured at the end of the latest job."""

    n_shards: int
    live_shards: tuple[int, ...]
    events_per_shard: dict[int, int]
    gossip_rounds: int
    gossip_messages: int
    gossip_suppressed: int
    staleness_max_s: float
    staleness_mean_s: float
    cross_steals: int
    takeovers: int
    n_ckills: int
    event_cost_s: float

    @property
    def total_events(self) -> int:
        return sum(self.events_per_shard.values())

    @property
    def max_shard_events(self) -> int:
        return max(self.events_per_shard.values(), default=0)

    @property
    def dispatch_throughput(self) -> float:
        """Achievable dispatch events/sec with shards handling their event
        streams in parallel: the busiest shard is the bottleneck."""
        busiest = self.max_shard_events * self.event_cost_s
        return self.total_events / max(busiest, _EPS)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["live_shards"] = list(self.live_shards)
        d["events_per_shard"] = {str(k): v for k, v in
                                 sorted(self.events_per_shard.items())}
        d["total_events"] = self.total_events
        d["max_shard_events"] = self.max_shard_events
        d["dispatch_throughput"] = self.dispatch_throughput
        return d

    def summary(self) -> str:
        ev = " ".join(f"s{k}:{v}" for k, v in
                      sorted(self.events_per_shard.items()))
        return (
            f"K={self.n_shards} ({len(self.live_shards)} live) "
            f"events[{ev}] -> {self.dispatch_throughput:.0f} ev/s, "
            f"gossip {self.gossip_rounds} rounds/{self.gossip_messages} msgs "
            f"(staleness max {self.staleness_max_s:.3f}s), "
            f"{self.cross_steals} cross-steals, {self.takeovers} takeovers"
        )


def rendezvous_shard(worker: str, shards: list[int]) -> int:
    """Highest-random-weight assignment of ``worker`` to one of ``shards``:
    consistent (stable keys, minimal movement on membership change) and
    deterministic across processes (crc32, not salted ``hash``)."""
    if not shards:
        raise ValueError("no live coordinator shards")
    return max(shards, key=lambda s: (
        zlib.crc32(f"{worker}|shard{s}".encode()), s
    ))


class ShardedCoordinator(DispatchAuthority):
    """K-sharded dispatch authority over one ``AsyncRuntime`` event loop."""

    def __init__(self, spec: CoordSpec):
        self.spec = spec
        k = spec.coordinators
        self.alive: set[int] = set(range(k))
        self.owner: dict[str, int] = {}
        self.groups: dict[int, int] | None = None   # partition state
        self.bus = GossipBus(k, fanout=spec.fanout,
                             period_s=spec.period_s or 1.0)
        self.events_per_shard: dict[int, int] = {s: 0 for s in range(k)}
        self.cross_steals = 0
        self.takeovers = 0
        self.n_ckills = 0
        self._staleness: tuple[float, float] = (0.0, 0.0)   # (max, mean)
        # shard -> live-worker list, rebuilt lazily; every membership change
        # (join, worker kill, ckill takeover) clears it.
        self._shard_cache: dict[int, list[str]] = {}

    # -- membership ----------------------------------------------------------
    def bind(self, runtime) -> None:
        super().bind(runtime)
        for name in runtime.workers:
            self.on_join(name)

    def on_join(self, name: str, ctx: JobContext | None = None) -> None:
        self._shard_cache.clear()
        if name not in self.owner:
            self.owner[name] = rendezvous_shard(name, sorted(self.alive))
        now = getattr(self.runtime, "clock", 0.0)
        try:
            perf = self.runtime.tracker.perf(name)
        except KeyError:
            perf = 1.0
        self.bus.views[self.owner[name]].update(name, perf, now)

    def on_worker_kill(self, name: str, ctx: JobContext | None = None) -> None:
        self._shard_cache.clear()
        shard = self.owner.get(name)
        if shard is not None:
            entry = self.bus.views[shard].entries.get(name)
            stamp = entry.stamp if entry is not None else 0.0
            self.bus.views[shard].update(name, _EPS, stamp, alive=False)

    def shard_workers(self, shard: int, ctx: JobContext) -> list[str]:
        """The live workers shard ``shard`` currently has authority over.
        Cached per shard (membership changes clear it) — callers must not
        mutate the returned list."""
        ws = self._shard_cache.get(shard)
        if ws is None or self.runtime.eta_mode == "recompute":
            ws = [
                w for w, s in self.owner.items()
                if s == shard and w in self.runtime.workers
                and w not in ctx.dead
            ]
            self._shard_cache[shard] = ws
        return ws

    # -- lifecycle -----------------------------------------------------------
    def begin_job(self, ctx: JobContext) -> None:
        self._shard_cache.clear()
        now = ctx.clock()
        for name in self.runtime.workers:
            if name not in self.owner:
                self.on_join(name)
        if self.spec.period_s is None and ctx.n_grains > 0:
            # Derive a per-job period: ~16 gossip rounds over the predicted
            # makespan.  Raw EMA perfs (no staleness decay) — idle gaps
            # between jobs must not inflate the estimate and starve the bus.
            # A degenerate estimate (zero-cost grains) keeps the previous
            # period: the bus must never spin faster than real events.
            total = sum(ctx.cost_of(g) for g in range(ctx.n_grains)) \
                if self.runtime.workers else 0.0
            tracker = self.runtime.tracker
            rate = 0.0
            for w in self.runtime.workers:
                try:
                    rate += tracker.perf(w)
                except KeyError:
                    rate += 1.0
            est = total / max(rate, _EPS)
            if est > 0:
                self.bus.period_s = est / 16.0
        self.bus.next_round_s = now + self.bus.period_s
        tracer = self.runtime.tracer
        if tracer is None:
            self.bus.trace_hook = None
        else:
            bus = self.bus

            def _on_round(round_idx: int, n_live: int, d_msgs: int,
                          d_merged: int, d_supp: int) -> None:
                # Staleness *at merge*: how far the freshest-lagging live
                # view trails the owners' latest observations right now.
                tracer.emit(
                    "gossip", round_idx=round_idx, n_live=n_live,
                    fanout=bus.fanout, messages=d_msgs, merged=d_merged,
                    suppressed=d_supp,
                    staleness_max_s=self._staleness_max_now(),
                )

            bus.trace_hook = _on_round

    def advance(self, now_s: float, ctx: JobContext) -> None:
        # Called before *every* event: bail without touching the bus unless a
        # round is actually due (exact complement of GossipBus.advance's fire
        # condition), so per-event cost is two float compares.  The reference
        # recompute mode keeps the old always-snapshot behavior for honest
        # before/after timing.
        if (now_s + 1e-12 < self.bus.next_round_s
                and self.runtime.eta_mode != "recompute"):
            return
        before = dict(self.bus.messages_by_shard)
        if self.bus.advance(now_s, sorted(self.alive), self.groups):
            # Each message a shard actually handled costs it one event — a
            # partitioned-away shard exchanged nothing and is charged
            # nothing.
            for s, n in self.bus.messages_by_shard.items():
                self.events_per_shard[s] += n - before.get(s, 0)

    def _staleness_max_now(self) -> float:
        """Worst lag of any live shard's view behind the owner-side truth —
        the per-round sample the gossip trace events carry.  Only called
        when tracing is on (O(shards x workers))."""
        tracker = self.runtime.tracker
        worst = 0.0
        for s in sorted(self.alive):
            view = self.bus.views[s]
            for w in self.runtime.workers:
                truth = tracker.last_report_s(w)
                if truth is None:
                    continue
                lag = view.staleness(w, truth)
                if lag is not None and lag > worst:
                    worst = lag
        return worst

    def end_job(self, ctx: JobContext) -> None:
        # Staleness of every live shard's view of every live worker, against
        # the owner's latest observation (the single-tracker truth).
        tracker = self.runtime.tracker
        lags: list[float] = []
        # A worker entirely unknown to a view counts as stale for the whole
        # job (the worst a live entry could be).
        span = max(ctx.res.makespan, _EPS)
        for s in sorted(self.alive):
            view = self.bus.views[s]
            for w in self.runtime.workers:
                truth = tracker.last_report_s(w)
                if truth is None:
                    continue
                lag = view.staleness(w, truth)
                lags.append(span if lag is None else lag)
        if lags:
            self._staleness = (max(lags), sum(lags) / len(lags))

    # -- perf view -----------------------------------------------------------
    def observe(self, report: PerfReport, ctx: JobContext) -> None:
        tracker = self.runtime.tracker
        tracker.observe(report)
        shard = self.owner.get(report.worker)
        if shard is None or shard not in self.alive:
            return
        try:
            perf = tracker.perf(report.worker)   # raw EMA, no decay
        except KeyError:
            return
        self.bus.views[shard].update(report.worker, perf, report.time_s)

    def _perf_of(self, shard: int, ctx: JobContext):
        view = self.bus.views[shard]
        half_life = self.runtime.tracker.staleness_half_life_s

        def perf(w: str) -> float:
            return max(view.perf_at(w, ctx.clock(), half_life), _EPS)

        return perf

    # -- decisions -----------------------------------------------------------
    def rebalance(self, ctx: JobContext, worker: str | None = None) -> None:
        if worker is None:
            shards = sorted(self.alive)
        else:
            s = self.owner.get(worker)
            shards = (min(self.alive) if s is None else s,)
        recompute = self.runtime.eta_mode == "recompute"
        for s in shards:
            if s not in self.alive:
                continue
            live = self.shard_workers(s, ctx)
            if len(live) < 2:
                continue
            if recompute:
                # Reference path: per-worker view lookups through the
                # closure chain, recomputed from scratch every event.
                perf_of = self._perf_of(s, ctx)
                self.runtime._rebalance_reference(
                    live, {w: ctx.queues[w] for w in live},
                    lambda w: ctx.eta_with(w, perf_of), ctx.cost_of,
                    perf_of, ctx.res,
                )
                continue
            est, etas = ctx.etas_under_view(
                live, self.bus.views[s].entries.get,
                self.runtime.tracker.staleness_half_life_s,
            )
            self.runtime._rebalance(
                live, ctx.queues, ctx.cost_of, est, ctx.res, etas,
            )

    def steal_for(self, thief: str, ctx: JobContext) -> int:
        s = self.owner.get(thief)
        if s is None or s not in self.alive:
            return 0
        perf_of = self._perf_of(s, ctx)

        def eta(w: str) -> float:
            return ctx.eta_with(w, perf_of)

        local = self.shard_workers(s, ctx)
        took = self.runtime._steal_into(
            thief, {w: ctx.queues[w] for w in local}, eta, perf_of, ctx.res
        )
        if took:
            return took
        return self._cross_shard_steal(thief, s, eta, perf_of, ctx)

    def _cross_shard_steal(self, thief: str, s: int, eta, perf_of,
                           ctx: JobContext) -> int:
        """Shard ``s`` drained: pull the tail of the worst remote queue,
        proportional to *gossiped* perf, hysteresis-gated like any other
        re-homogenization.  Costs one negotiation event on each side."""
        reachable = [
            t for t in sorted(self.alive)
            if t != s and (self.groups is None
                           or self.groups.get(t) == self.groups.get(s))
        ]
        best: tuple[float, int, str] | None = None
        for t in reachable:
            for w in self.shard_workers(t, ctx):
                if ctx.queues.get(w):
                    e = eta(w)
                    if best is None or e > best[0]:
                        best = (e, t, w)
        if best is None:
            return 0
        victim_eta, t, victim = best
        if not should_replan([eta(thief), victim_eta],
                             self.runtime.replan_threshold):
            return 0
        # The move itself is the ordinary tail-steal (proportional split,
        # accounting and all) — only the victim search above and the
        # negotiation bookkeeping below are cross-shard specific.
        take = self.runtime._steal_into(
            thief, {victim: ctx.queues[victim], thief: ctx.queues[thief]},
            eta, perf_of, ctx.res,
        )
        if take <= 0:
            return 0
        # Ownership of the stolen grains follows the thief's shard; the
        # negotiation is one dispatch event on each coordinator.
        self.events_per_shard[s] += 1
        self.events_per_shard[t] += 1
        self.cross_steals += 1
        tracer = self.runtime.tracer
        if tracer is not None:
            tracer.emit("cross_steal", worker=victim, to=thief,
                        shard=t, thief_shard=s, take=take)
        return take

    def heir_for(self, name: str, live: list[str], ctx: JobContext) -> str:
        """A dead worker's orphans re-home within its own shard when it still
        has live workers (the shard's authority never leaves it), otherwise
        to the earliest-finishing worker fleet-wide under the owner shard's
        gossiped view."""
        s = self.owner.get(name)
        if s is None or s not in self.alive:
            return super().heir_for(name, live, ctx)
        perf_of = self._perf_of(s, ctx)
        same = [w for w in live if self.owner.get(w) == s]
        pool = same or live
        return min(pool, key=lambda w: ctx.eta_with(w, perf_of))

    # -- coordinator faults --------------------------------------------------
    def apply_coord_event(self, ev: TimelineEvent, now_s: float,
                          ctx: JobContext) -> None:
        if ev.kind == "ckill":
            self._ckill(int(ev.worker), now_s, ctx)
        elif ev.kind == "partition":
            self._partition(ev.worker)
        elif ev.kind == "heal":
            self.groups = None
            for s in self.alive:
                self.events_per_shard[s] += 1

    def _ckill(self, shard: int, now_s: float, ctx: JobContext) -> None:
        if shard not in self.alive:
            return   # stale script: already dead (or never existed)
        self.n_ckills += 1
        self.alive.discard(shard)
        if not self.alive:
            # No authority left.  In-flight grains still complete (workers
            # keep computing), but queued work has nothing to dispatch it —
            # only that case is fatal, mirroring the worker-kill path.
            undispatched = sum(
                len(ctx.queues[w]) for w in self.runtime.workers
                if w not in ctx.dead
            )
            if undispatched:
                raise RuntimeError(
                    f"coordinator shard {shard} was the last one alive; the "
                    f"coordination plane is gone with {undispatched} grains "
                    "undispatched"
                )
            return
        # Ring successor: the next live shard id, wrapping — it adopts the
        # dead shard's workers, their queues and in-flight bookkeeping.
        order = sorted(self.alive)
        successor = next((s for s in order if s > shard), order[0])
        adopted = [w for w, s in self.owner.items() if s == shard]
        for w in adopted:
            self.owner[w] = successor
        self._shard_cache.clear()
        # The dead shard's private view dies with it; the successor governs
        # the adopted workers from its own (gossiped, possibly stale) view —
        # fresh heartbeats re-teach it within an EMA window.
        self.takeovers += 1
        self.events_per_shard[successor] += 1 + len(adopted)
        tracer = self.runtime.tracer
        if tracer is not None:
            tracer.emit("ckill", t_s=now_s, shard=shard,
                        successor=successor, adopted=len(adopted))

    def _partition(self, groups: tuple[tuple[int, ...], ...]) -> None:
        group_of: dict[int, int] = {}
        for gi, group in enumerate(groups):
            for s in group:
                group_of[int(s)] = gi
        # Unlisted shards each form their own singleton group.
        nxt = len(groups)
        for s in self.alive:
            if s not in group_of:
                group_of[s] = nxt
                nxt += 1
        self.groups = group_of
        for s in self.alive:
            self.events_per_shard[s] += 1

    # -- accounting ----------------------------------------------------------
    def count_event(self, worker: str | None, kind: str,
                    ctx: JobContext) -> None:
        if worker is None:
            return
        shard = self.owner.get(worker)
        if shard is None:
            return
        self.events_per_shard[shard] += 1

    def stats(self) -> CoordStats:
        return CoordStats(
            n_shards=self.spec.coordinators,
            live_shards=tuple(sorted(self.alive)),
            events_per_shard=dict(self.events_per_shard),
            gossip_rounds=self.bus.n_rounds,
            gossip_messages=self.bus.n_messages,
            gossip_suppressed=self.bus.n_suppressed,
            staleness_max_s=self._staleness[0],
            staleness_mean_s=self._staleness[1],
            cross_steals=self.cross_steals,
            takeovers=self.takeovers,
            n_ckills=self.n_ckills,
            event_cost_s=self.spec.event_cost_s,
        )
