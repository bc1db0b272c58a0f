"""Materializing workload clauses into an open-loop arrival plan.

A ``Scenario``'s workload clauses (``arrive:``/``burst:``/``mix:``) compile —
like fault clauses — onto the ``TimelineEvent``/phase-callback machinery, but
they are *consumed* here rather than executed by the runtime: the serving
layer needs the concrete per-request arrival times before the stream starts
(they define how many requests the stream even has).

Open-loop phases are **SLO windows**: fixed ``window_s``-second slices of the
stream clock.  Unlike waves (whose true start depends on how fast the
previous wave drained), window k starts at exactly ``k * window_s`` — so
anchoring ``phase_events(k, k * window_s)`` is exact by construction, and a
phase-relative clause like ``arrive:poisson(8)@1:50%`` lands at precisely 1.5
windows into the stream.  The same ``ScenarioSchedule`` drain loop the
closed-loop workloads use per-wave runs here up front, which keeps one
anchoring mechanism across both serving modes.
"""

from __future__ import annotations

import dataclasses

from ..core.runtime import TimelineEvent
from .scenario import ScenarioSchedule

__all__ = ["ArrivalPlan", "materialize_workload"]


@dataclasses.dataclass(frozen=True)
class ArrivalPlan:
    """The concrete traffic a scenario's workload clauses describe."""

    arrive_s: tuple[float, ...]              # sorted, stream-relative seconds
    mix: tuple[tuple[float, float], ...]     # (time_s, length factor)
    timeline: tuple[TimelineEvent, ...]      # the remaining fault/coord events

    @property
    def n_requests(self) -> int:
        return len(self.arrive_s)

    def lengths_factor(self, t: float) -> float:
        """Cumulative request-length scale for a request arriving at ``t``
        (every ``mix:len*F`` clause at or before ``t`` applies)."""
        f = 1.0
        for at, factor in self.mix:
            if t >= at:
                f *= factor
        return f


def materialize_workload(
    schedule: ScenarioSchedule,
    window_s: float,
    max_windows: int = 10_000,
) -> ArrivalPlan:
    """Drain ``schedule`` against deterministic SLO-window starts
    (``k * window_s``) and split the events into arrivals, mix shifts and the
    fault timeline the runtime executes."""
    if window_s <= 0:
        raise ValueError("window_s must be > 0")
    arrivals: list[float] = []
    mix: list[tuple[float, float]] = []
    faults: list[TimelineEvent] = []
    k = 0
    while not schedule.exhausted and k < max_windows:
        for ev in schedule.phase_events(k, k * window_s):
            if ev.kind == "arrive":
                arrivals.extend(ev.time_s + off for off in ev.worker)
            elif ev.kind == "mix":
                mix.append((ev.time_s, ev.perf))
            else:
                faults.append(ev)
        k += 1
    mix.sort()
    faults.sort(key=lambda e: e.time_s)
    return ArrivalPlan(tuple(sorted(arrivals)), tuple(mix), tuple(faults))
