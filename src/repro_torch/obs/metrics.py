"""Counters / gauges / histograms with a deterministic snapshot order.

The registry is the aggregation half of the observability plane: the
``Tracer`` (obs.trace) rolls every emitted event into it (one counter per
event kind, plus value histograms for service times and TTFTs), and the
Cluster facade publishes ``registry.snapshot()`` as ``RunReport.telemetry``.

Determinism contract: ``snapshot()`` sorts every key and derives histogram
percentiles by exact rank on the sorted sample list — two runs that emit the
same events in the same order produce byte-identical snapshots.  Nothing
here reads a wall clock; callers pass every value in.
"""

from __future__ import annotations

__all__ = ["MetricsRegistry"]


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated percentile on an already-sorted sample."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class MetricsRegistry:
    """In-memory metrics: ``count`` (monotone counters), ``gauge`` (last
    value wins), ``observe`` (histogram samples).  All plain floats/ints —
    snapshotting is the only aggregation step."""

    def __init__(self) -> None:
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, list[float]] = {}

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self.hists.setdefault(name, []).append(float(value))

    def snapshot(self) -> dict:
        """Deterministic rollup: sorted keys, histograms reduced to
        count/sum/min/max/mean/p50/p99 (exact-rank percentiles)."""
        hists = {}
        for name in sorted(self.hists):
            vals = sorted(self.hists[name])
            total = sum(vals)
            hists[name] = {
                "count": len(vals),
                "sum": total,
                "min": vals[0],
                "max": vals[-1],
                "mean": total / len(vals),
                "p50": _percentile(vals, 0.50),
                "p99": _percentile(vals, 0.99),
            }
        return {
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
            "histograms": hists,
        }
