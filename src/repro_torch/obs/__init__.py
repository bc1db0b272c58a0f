"""Observability plane: structured tracing, metrics, and trace exporters.

``Tracer`` collects typed lifecycle events from every layer (runtime,
coordinators, gossip, serve pool, execution backends) with logical *and*
wall timestamps; ``MetricsRegistry`` rolls them into the deterministic
snapshot that becomes ``RunReport.telemetry``; ``obs.export`` writes
Perfetto ``trace_event`` JSON and JSONL streams.  See each module's
docstring for the contracts (zero-overhead off path, dual clocks,
deterministic snapshots).
"""

from .export import to_perfetto, write_jsonl, write_trace
from .metrics import MetricsRegistry
from .trace import EVENT_KINDS, TraceEvent, Tracer

__all__ = [
    "EVENT_KINDS", "MetricsRegistry", "TraceEvent", "Tracer",
    "to_perfetto", "write_jsonl", "write_trace",
]
