"""Structured run tracing: typed lifecycle events with dual timestamps.

One ``Tracer`` instance observes one run (or several back-to-back runs on
the same runtime).  Every layer that can see it emits typed events through
``emit(kind, ...)``:

  grain lifecycle   enqueue / dispatch / start / heartbeat / migrate /
                    steal / abort / complete
  serve pool        arrive / admit / shed / handoff / first_token /
                    ttft_drop / request_done
  coordinator       rebalance / cross_steal / ckill / gossip
  scenario          fault
  backend           settle (wallclock measurement reconciliation)

Each event carries the *logical* clock (``t_s`` — simulated seconds under
``SimBackend``, measured seconds under ``WallclockBackend``, so both
backends trace identically) and a *wall* timestamp (``wall_s`` — real
seconds since the tracer was created), plus an optional worker, grain id,
and a free-form data dict.

The emitting layers guard every call site with ``if tracer is not None:``
— the no-tracer path loads one attribute and branches, nothing else, which
is what keeps it bitwise-identical and within noise on ``bench_loop``
(asserted there and in ``tests/test_obs.py``).

The logical clock is *injected*: the runtime calls ``set_clock`` with its
job-context clock at job start, so emit sites that have no ``now`` in scope
(rebalance moves, steals, gossip rounds) still stamp correctly.  Call sites
that do have ``now`` pass it explicitly via ``t_s=``.

Metrics roll up as events arrive (one counter per kind; service-time and
TTFT histograms; per-worker ``rate.<w>`` gauges from heartbeats — TTFT is
derived inside the tracer by pairing each ``first_token`` with its grain's
``arrive``, since the emitting executor never sees arrival times) into a
``MetricsRegistry``
whose ``snapshot()`` becomes ``RunReport.telemetry``.  With
``metrics_interval_s`` set, the tracer prints a one-line stat summary every
time the logical clock crosses the next interval boundary — the live-run
heartbeat for long open-loop streams.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from .metrics import MetricsRegistry

__all__ = ["TraceEvent", "Tracer", "EVENT_KINDS"]

#: The closed event vocabulary (exporters render anything, but tests assert
#: emitting layers stay inside it).
EVENT_KINDS = frozenset({
    # grain lifecycle
    "enqueue", "dispatch", "start", "heartbeat", "migrate", "steal",
    "abort", "complete",
    # serve pool
    "arrive", "admit", "shed", "handoff", "first_token", "ttft_drop",
    "request_done",
    # coordinator
    "rebalance", "cross_steal", "ckill", "gossip",
    # scenario + backend
    "fault", "settle",
})


@dataclasses.dataclass(slots=True)
class TraceEvent:
    kind: str                  # one of EVENT_KINDS
    t_s: float                 # logical clock (sim or measured seconds)
    wall_s: float              # real seconds since the tracer's creation
    worker: str | None         # track owner (None -> coordinator track)
    grain: int | None          # grain / request id when applicable
    data: dict[str, Any]       # kind-specific payload


class Tracer:
    """Collects ``TraceEvent``s and rolls them into a ``MetricsRegistry``.

    Parameters:
      metrics_interval_s  print a one-line summary every S logical seconds
                          (None: silent),
      log_fn              where interval summaries go (default ``print``).
    """

    def __init__(self, metrics_interval_s: float | None = None,
                 log_fn: Callable[[str], None] = print) -> None:
        self.events: list[TraceEvent] = []
        self.metrics = MetricsRegistry()
        self.metrics_interval_s = (
            float(metrics_interval_s) if metrics_interval_s else None
        )
        self.log_fn = log_fn
        self._origin = time.perf_counter()
        self._clock: Callable[[], float] = lambda: 0.0
        # arrive-time per grain, so first_token events (emitted by executors
        # that never see arrival times) still yield a TTFT sample.
        self._arrive_s: dict[int, float] = {}
        self._next_report_s = (
            self.metrics_interval_s if self.metrics_interval_s else None
        )

    # -- wiring ---------------------------------------------------------------
    def set_clock(self, clock: Callable[[], float]) -> None:
        """Inject the logical clock (the runtime's job-context ``clock``) so
        emit sites without a ``now`` in scope stamp correctly."""
        self._clock = clock

    # -- the hot entry point (only reached when tracing is ON) ----------------
    def emit(self, kind: str, *, t_s: float | None = None,
             worker: str | None = None, grain: int | None = None,
             **data: Any) -> None:
        t = self._clock() if t_s is None else t_s
        self.events.append(TraceEvent(
            kind, t, time.perf_counter() - self._origin, worker, grain, data,
        ))
        m = self.metrics
        m.count("events." + kind)
        if kind == "complete":
            start = data.get("start_s")
            if start is not None:
                m.observe("grain_service_s", t - start)
        elif kind == "first_token":
            ttft = data.get("ttft_s")
            if ttft is None and grain in self._arrive_s:
                ttft = t - self._arrive_s[grain]
            if ttft is not None:
                m.observe("ttft_s", ttft)
        elif kind == "arrive" and grain is not None:
            self._arrive_s[grain] = t
        elif kind == "heartbeat" and worker is not None:
            el = data.get("elapsed_s")
            if el:
                m.gauge("rate." + worker, data.get("work", 0.0) / el)
        elif kind == "migrate" or kind == "steal":
            m.count("grains_moved")
        if self._next_report_s is not None and t >= self._next_report_s:
            # One line per crossed boundary, not per missed interval.
            interval = self.metrics_interval_s
            self._next_report_s += (
                int((t - self._next_report_s) / interval) + 1
            ) * interval
            self.log_fn(self.summary_line(t))

    # -- reporting ------------------------------------------------------------
    def summary_line(self, t_s: float | None = None) -> str:
        """One-line live stats: event totals for the kinds that tell the
        load-balancing story."""
        c = self.metrics.counters
        t = self._clock() if t_s is None else t_s
        parts = [f"[obs t={t:9.3f}s]", f"events={len(self.events)}"]
        for kind in ("complete", "migrate", "steal", "shed", "abort",
                     "gossip", "rebalance"):
            n = c.get("events." + kind, 0)
            if n:
                parts.append(f"{kind}={n}")
        return " ".join(parts)

    def telemetry(self) -> dict:
        """The ``RunReport.telemetry`` payload: metrics snapshot plus the raw
        event count (the events themselves live in the tracer / export
        files, not the report)."""
        snap = self.metrics.snapshot()
        snap["n_events"] = len(self.events)
        return snap

    def export(self, path: str) -> int:
        """Write the collected events to ``path``: Perfetto/Chrome
        ``trace_event`` JSON, or compact JSONL when the path ends in
        ``.jsonl``.  Returns the number of events written."""
        from .export import write_trace
        return write_trace(self.events, path)
