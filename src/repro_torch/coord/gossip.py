"""Deterministic round-based gossip of per-shard performance views.

Each coordinator shard owns a ``PerfView``: its private table of
``worker -> (perf, stamp, alive)``.  The owner shard of a worker updates the
entry from every real heartbeat; everyone else learns it through the
``GossipBus`` — a deterministic push-pull protocol that runs one round every
``period_s`` simulated seconds.  In round ``r`` each live shard exchanges
views with the peer ``offset = 2^((r * fanout + j) % ceil(log2 n))`` positions
away on the sorted live-shard list (``j < fanout``), the classic doubling
dissemination schedule: one shard's fresh observation reaches every other
shard within ``ceil(log2 n)`` rounds at fanout 1, and proportionally faster
at higher fanout.

Merges are *staleness-aware*: an incoming entry replaces the local one only
if its stamp is newer — so delayed gossip can never roll a view backwards,
and after enough rounds every shard's view converges on exactly the table a
single global tracker would hold.  A network partition (scenario ``partition``
clause) suppresses exchanges across group boundaries; the suppressed messages
are counted so reports can show what the partition cost.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["PerfEntry", "PerfView", "GossipBus"]


@dataclasses.dataclass(slots=True)
class PerfEntry:
    perf: float                # homogenized perf as last observed/gossiped
    stamp: float               # observation time (staleness ordering key)
    alive: bool = True


class PerfView:
    """One coordinator shard's private perf table."""

    def __init__(self) -> None:
        self.entries: dict[str, PerfEntry] = {}

    def update(self, worker: str, perf: float, stamp: float,
               alive: bool = True) -> None:
        """Local observation by the owner shard (always authoritative)."""
        self.entries[worker] = PerfEntry(float(perf), float(stamp), alive)

    def merge_from(self, other: "PerfView") -> int:
        """Staleness-aware merge: an entry crosses only if strictly newer.
        Returns how many entries were refreshed.

        Refreshed entries are *shared* with the source view, not copied:
        entries are replace-only (``update``/``merge_from`` always bind a new
        ``PerfEntry``, never mutate one in place), so aliasing is safe and
        keeps gossip ingest allocation-free on the heartbeat hot path."""
        fresh = 0
        mine = self.entries
        for w, e in other.entries.items():
            m = mine.get(w)
            if m is None or e.stamp > m.stamp:
                mine[w] = e
                fresh += 1
        return fresh

    def perf_at(self, worker: str, now_s: float,
                staleness_half_life_s: float = 60.0,
                default: float = 1.0) -> float:
        """Decision-time perf estimate under this view, with the tracker's
        staleness-decay convention (halve trust per half-life without news).
        Unknown workers get the neutral ``default`` prior — exactly what a
        coordinator that just adopted a worker would assume."""
        e = self.entries.get(worker)
        if e is None:
            return default
        p = e.perf
        if now_s > e.stamp:
            p *= 0.5 ** ((now_s - e.stamp) / staleness_half_life_s)
        return p

    def perf_floor_map(self, workers, now_s: float,
                       staleness_half_life_s: float = 60.0,
                       default: float = 1.0,
                       floor: float = 0.0) -> dict[str, float]:
        """Bulk ``perf_at`` with a floor, in one pass.  Bitwise-identical to
        ``max(self.perf_at(w, now_s, half_life, default), floor)`` per
        worker — the semantic reference for the runtime's fused
        ``etas_under_view`` hot path, which inlines this decay per worker."""
        out: dict[str, float] = {}
        get = self.entries.get
        for w in workers:
            e = get(w)
            if e is None:
                p = default
            else:
                p = e.perf
                stamp = e.stamp
                if now_s > stamp:
                    p *= 0.5 ** ((now_s - stamp) / staleness_half_life_s)
            out[w] = p if p >= floor else floor
        return out

    def staleness(self, worker: str, truth_stamp: float) -> float | None:
        """How far this view lags the owner's latest observation (None if the
        worker is entirely unknown here)."""
        e = self.entries.get(worker)
        if e is None:
            return None
        return max(0.0, truth_stamp - e.stamp)


class GossipBus:
    """The deterministic exchange schedule over ``n_shards`` PerfViews."""

    def __init__(self, n_shards: int, fanout: int = 1,
                 period_s: float = 1.0, start_s: float = 0.0) -> None:
        if n_shards < 1:
            raise ValueError("gossip bus needs >= 1 shard")
        if fanout < 1:
            raise ValueError("gossip fanout must be >= 1")
        if period_s <= 0:
            raise ValueError("gossip period must be > 0")
        self.n_shards = n_shards
        self.fanout = fanout
        self.period_s = period_s
        self.views = [PerfView() for _ in range(n_shards)]
        self.round_idx = 0
        self.next_round_s = start_s + period_s
        # Cumulative stats (ride into CoordStats).
        self.n_rounds = 0
        self.n_messages = 0
        self.n_suppressed = 0      # exchanges dropped by a partition
        self.n_merged = 0          # entries actually refreshed by merges
        # Messages actually handled per shard (one per exchange on each
        # side) — a partitioned-away shard handles nothing and is charged
        # nothing.
        self.messages_by_shard: dict[int, int] = {
            s: 0 for s in range(n_shards)
        }
        #: Optional per-round observer (the tracing plane): called after each
        #: round as ``hook(round_idx, n_live, d_messages, d_merged,
        #: d_suppressed)``.  None (the default) costs one load per round.
        self.trace_hook = None

    #: Catch-up bound per advance() call: a mis-estimated (too small) period
    #: degrades to at most this many rounds between events instead of
    #: spinning the event loop; the skipped rounds carry no information a
    #: fresh exchange would not (views only hold the latest entries).
    MAX_CATCHUP_ROUNDS = 64

    def advance(self, now_s: float, live: list[int],
                group_of: dict[int, int] | None = None) -> int:
        """Run every round due at or before ``now_s`` (bounded by
        ``MAX_CATCHUP_ROUNDS``; a long gap then jumps the schedule forward).
        Returns how many rounds fired.  ``live`` lists the shard ids still
        alive; ``group_of`` (partition state) maps shard -> group id,
        cross-group exchanges are suppressed."""
        fired = 0
        while self.next_round_s <= now_s + 1e-12:
            self.run_round(live, group_of)
            self.next_round_s += self.period_s
            fired += 1
            if fired >= self.MAX_CATCHUP_ROUNDS:
                # Skip the remaining missed rounds in one arithmetic jump.
                behind = now_s - self.next_round_s
                if behind > 0:
                    self.next_round_s += (
                        int(behind / self.period_s) + 1
                    ) * self.period_s
                break
        return fired

    def run_round(self, live: list[int],
                  group_of: dict[int, int] | None = None) -> None:
        """One deterministic push-pull round over the sorted live shards."""
        order = sorted(live)
        n = len(order)
        self.round_idx += 1
        self.n_rounds += 1
        hook = self.trace_hook
        if hook is not None:
            m0, g0, s0 = self.n_messages, self.n_merged, self.n_suppressed
        if n < 2:
            if hook is not None:
                hook(self.round_idx, n, 0, 0, 0)
            return
        n_offsets = max(1, math.ceil(math.log2(n)))
        for j in range(self.fanout):
            offset = 1 << ((self.round_idx - 1) * self.fanout + j) % n_offsets
            for pos, i in enumerate(order):
                peer = order[(pos + offset) % n]
                if peer == i:
                    continue
                if group_of is not None and group_of.get(i) != group_of.get(peer):
                    self.n_suppressed += 1
                    continue
                # Push-pull: both directions merge, newer stamps win.
                self.n_merged += self.views[peer].merge_from(self.views[i])
                self.n_merged += self.views[i].merge_from(self.views[peer])
                self.n_messages += 2
                self.messages_by_shard[i] += 1
                self.messages_by_shard[peer] += 1
        if hook is not None:
            hook(self.round_idx, n, self.n_messages - m0,
                 self.n_merged - g0, self.n_suppressed - s0)

    def rounds_to_converge(self, n_live: int) -> int:
        """The dissemination bound: full convergence within this many rounds
        (``ceil(log2 n)`` at fanout 1, shrinking with fanout)."""
        if n_live < 2:
            return 0
        return math.ceil(math.ceil(math.log2(n_live)) / self.fanout)
