"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON and compact JSONL.

Perfetto mapping (open the file at https://ui.perfetto.dev):

  track layout   one named thread per worker (sorted), one ``coordinator``
                 thread for fleet-level events, plus one thread per
                 coordinator shard (``coord/K``) when sharded events carry a
                 shard id — all under a single ``repro`` process,
  grain slices   every ``complete`` event becomes a ``ph:"X"`` duration
                 slice from its carried ``start_s`` to the completion time
                 on the executing worker's track,
  migrations     every ``migrate``/``steal``/``cross_steal`` event becomes a
                 flow arrow (``ph:"s"`` on the donor track at decision time,
                 ``ph:"f"`` binding to the grain's eventual dispatch — or
                 completion — on the recipient track), so rebalancing is
                 visible as arrows leaving the straggler,
  instants       every other kind renders as a ``ph:"i"`` instant on its
                 worker's (or the coordinator's) track.

Timestamps are the events' *logical* clock in microseconds — simulated
seconds under the sim backend, measured seconds under wallclock — so traces
from both backends read identically.  The wall timestamp rides along in
``args.wall_s``.

JSONL (``*.jsonl`` paths): one event object per line, all fields flat —
the grep/jq-friendly stream for long open-loop runs.
"""

from __future__ import annotations

import json
from typing import Iterable

from .trace import TraceEvent

__all__ = ["to_perfetto", "write_trace", "write_jsonl"]

_PID = 1
_FLOW_KINDS = ("migrate", "steal", "cross_steal")


def _us(t_s: float) -> float:
    return round(t_s * 1e6, 3)


def to_perfetto(events: Iterable[TraceEvent]) -> dict:
    """Build the ``{"traceEvents": [...]}`` document (see module doc)."""
    events = list(events)
    workers = sorted({e.worker for e in events if e.worker is not None})
    shards = sorted({
        e.data["shard"] for e in events
        if e.worker is None and isinstance(e.data.get("shard"), int)
    })
    tids = {"coordinator": 0}
    for s in shards:
        tids[f"coord/{s}"] = len(tids)
    for w in workers:
        tids[w] = len(tids)

    # ts is optional on metadata per the spec; carried anyway so consumers
    # can treat every record uniformly.
    out = [
        {"ph": "M", "name": "process_name", "pid": _PID, "tid": 0, "ts": 0,
         "args": {"name": "repro"}},
    ]
    for name, tid in tids.items():
        out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                    "tid": tid, "ts": 0, "args": {"name": name}})

    def tid_of(e: TraceEvent) -> int:
        if e.worker is not None:
            return tids.get(e.worker, 0)
        shard = e.data.get("shard")
        return tids.get(f"coord/{shard}", 0) if shard is not None else 0

    # Index dispatch/complete times per grain so flow arrows can bind to the
    # grain's next appearance on the recipient track.
    landings: dict[int, list[tuple[float, str, int]]] = {}
    for e in events:
        if e.kind in ("dispatch", "complete") and e.grain is not None \
                and e.worker is not None:
            t = e.data.get("start_s", e.t_s) if e.kind == "complete" else e.t_s
            landings.setdefault(e.grain, []).append(
                (t, e.worker, tids[e.worker])
            )
    for lst in landings.values():
        lst.sort()

    flow_id = 0
    for e in events:
        base = {"pid": _PID, "tid": tid_of(e), "ts": _us(e.t_s),
                "cat": e.kind}
        args = {"wall_s": round(e.wall_s, 6), **e.data}
        if e.grain is not None:
            args["grain"] = e.grain
        if e.kind == "complete":
            start = e.data.get("start_s", e.t_s)
            name = f"g{e.grain}" if e.grain is not None else "grain"
            out.append({**base, "ph": "X", "name": name, "ts": _us(start),
                        "dur": _us(e.t_s - start), "args": args})
        elif e.kind in _FLOW_KINDS and e.grain is not None:
            to_w = e.data.get("to")
            # Bind the arrow to the grain's first dispatch/complete on the
            # recipient at or after the decision (None if it never lands —
            # e.g. the grain was shed or the run was truncated).
            landing = next(
                (l for l in landings.get(e.grain, ())
                 if l[0] >= e.t_s - 1e-12 and (to_w is None or l[1] == to_w)),
                None,
            )
            flow_id += 1
            out.append({**base, "ph": "i", "s": "t", "name": e.kind,
                        "args": args})
            if landing is not None:
                flow = {"pid": _PID, "cat": "flow", "name": e.kind,
                        "id": flow_id}
                out.append({**flow, "ph": "s", "tid": tid_of(e),
                            "ts": _us(e.t_s)})
                out.append({**flow, "ph": "f", "bp": "e", "tid": landing[2],
                            "ts": _us(landing[0])})
        else:
            out.append({**base, "ph": "i", "s": "t", "name": e.kind,
                        "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_jsonl(events: Iterable[TraceEvent], path: str) -> int:
    n = 0
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps({
                "kind": e.kind, "t_s": e.t_s, "wall_s": round(e.wall_s, 6),
                "worker": e.worker, "grain": e.grain, **e.data,
            }) + "\n")
            n += 1
    return n


def write_trace(events: Iterable[TraceEvent], path: str) -> int:
    """Format by extension: ``.jsonl`` -> JSONL stream, anything else ->
    Perfetto ``trace_event`` JSON.  Returns events written."""
    events = list(events)
    if path.endswith(".jsonl"):
        return write_jsonl(events, path)
    with open(path, "w") as f:
        json.dump(to_perfetto(events), f)
    return len(events)
