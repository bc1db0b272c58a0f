"""Serving launcher: a real continuous-batching engine fleet behind the
homogenized dispatcher, driven through the declarative Cluster API.

Port of ``repro/launch/serve.py`` with the same flags, plus ``--device``
(default ``cuda``; ``--device cpu`` runs the port's plain kernel versions on
the host).  ``--backend wallclock`` measures engine steps on the card
(``--devices`` of them, all visible by default) and, as in the reference,
refuses a scenario; ``--tuned`` applies the port's env profile
(``launch/env.py``).
The reference launcher's deprecated pre-Cluster shims (``parse_replicas``,
``build_fleet``, ``scenario_timeline``) are kept with its contract.

``--fleet`` is the ``FleetSpec`` grammar (``[NAME=]PERFxSLOTS[@PROFILE]``,
comma- or colon-separated — the old ``--replicas PERFxBATCH`` grammar is a
subset and the flag survives as an alias).  ``--scenario`` takes the legacy
names (``none``/``halving``/``kill``) or any Scenario DSL string
(``halve:r0@25%;join:r3=4x2@60%``).  Requests are served through one
``Cluster`` facade: admission-controlled waves on the batched EngineExecutor
path — slots stay full, tokens/sec heartbeats are measured, unstarted
requests migrate off degrading replicas, and joined replicas lazily bring
their engines.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --requests 24 --fleet 8x4:4x2:2x1 --scenario halving --compare-serial

Workload clauses (``arrive:``/``burst:``/``mix:``/``scale:``) switch the run
open-loop: requests *arrive* on the scenario's schedule, full queues shed or
backlog (``--overflow``), the report gains p50/p99 TTFT and goodput under
``--deadline``, and ``scale:`` rules join replicas on a measured SLO breach:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --requests 256 --fleet 8x4:4x2 --overflow shed --deadline 2 \
      --scenario 'arrive:poisson(8)@0-30 burst:64@10 scale:+2@p99>0.5'

Role suffixes (``^prefill``/``^decode``) in ``--fleet`` disaggregate the
stream: prompts prefill in one bucketed call on the prefill pool, KV hands
off to the decode pool, and the report adds the TTFT split
(queue/prefill/handoff/decode) plus per-role homogenization quality:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --requests 128 --fleet 'fast=2.0^prefill,slow=1.0x4^decode' \
      --scenario 'arrive:poisson(6)@0-20'
"""

from __future__ import annotations

import argparse

import numpy as np

from ..cluster import Cluster, FleetSpec, Scenario, ServeJob
from ..configs import ARCH_IDS, get_config
from ..models.model import Model
from ..serve.engine import Request
from .common import (
    add_backend_args,
    add_fleet_arg,
    add_trace_args,
    apply_env,
    export_trace,
    make_backend,
    make_tracer,
)


def parse_replicas(spec: str) -> list[tuple[float, int]]:
    """Deprecated: the old ``--replicas`` view of a fleet string.  Delegates
    to ``FleetSpec.parse``, preserving this function's historical contract
    that a bare-perf item means 4 slots (FleetSpec itself defaults bare
    items to 1).  Prefer consuming a FleetSpec directly."""
    items = [
        it if ("x" in it or "=" in it) else f"{it}x4"
        for it in (s.strip() for s in spec.replace(",", ":").split(":"))
        if it
    ]
    fleet = FleetSpec.parse(":".join(items), prefix="r")
    return [(w.perf, w.concurrency) for w in fleet.workers]


def build_fleet(model, params, specs, max_seq: int, queue_depth: int):
    """Deprecated shim for the pre-Cluster entry point: builds the legacy
    ``FleetServer`` (old callers, benchmarks at timing scale), one
    ``DecodeEngine`` a replica on the model's device.  New code should use
    ``Cluster(fleet).serve(ServeJob(...))``."""
    from ..serve.dispatch import Replica
    from ..serve.engine import DecodeEngine
    from ..serve.fleet import FleetServer

    replicas = [Replica(f"r{i}", p) for i, (p, _) in enumerate(specs)]
    engines = {
        f"r{i}": DecodeEngine(model, params, max_batch=b, max_seq=max_seq,
                              name=f"r{i}", device=model.device)
        for i, (_, b) in enumerate(specs)
    }
    return FleetServer(replicas, engines, max_queue_depth=queue_depth)


def make_requests(n: int, vocab: int, max_new: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [
        Request(rid=i, prompt=list(rng.integers(0, vocab, int(rng.integers(2, 8)))),
                max_new_tokens=max_new)
        for i in range(n)
    ]


def scenario_timeline(scenario: str, specs, requests):
    """Deprecated: the old hand-rolled timeline builder, now a Scenario DSL
    compile (``halving`` == ``halve:r0@25%``, ``kill`` == ``kill:r0@25%``)."""
    fleet = FleetSpec.from_dicts(
        [{"name": f"r{i}", "perf": p, "concurrency": b}
         for i, (p, b) in enumerate(specs)]
    )
    cost = sum(len(r.prompt) + r.max_new_tokens for r in requests)
    phase_s = cost / fleet.total_rate()
    return Scenario.from_arg(scenario, "r0").compile(fleet, phase_s=phase_s)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    add_fleet_arg(ap, legacy="--replicas", default="8x4:4x2:2x1",
                  help="FleetSpec grammar: [NAME=]PERFxSLOTS[@PROFILE] per "
                       "replica, ','/':'-separated (engine steps/sec x slots), "
                       "optional '/cK' suffix for K coordinator shards")
    add_backend_args(ap)
    ap.add_argument("--coordinators", type=int, default=None,
                    help="shard dispatch across K coordinator replicas "
                         "(overrides the fleet's '/cK' suffix)")
    ap.add_argument("--queue-depth", type=int, default=8,
                    help="admission control: max unstarted requests queued "
                         "per replica per wave")
    ap.add_argument("--scenario", default="none",
                    help="'none'|'halving'|'kill' (legacy names, fault 25%% "
                         "into the first wave) or a Scenario DSL string, e.g. "
                         "'halve:r0@25%%;join:r3=4x2@80%%'")
    ap.add_argument("--compare-serial", action="store_true",
                    help="also run the per-request-serial baseline on a "
                         "fresh fleet and report the batched speedup")
    ap.add_argument("--overflow", choices=("queue", "shed"), default="queue",
                    help="open-loop admission when every replica queue is "
                         "full: backlog the arrival or shed it (reject trace)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="open-loop SLO deadline in simulated seconds "
                         "(drives goodput accounting)")
    ap.add_argument("--window", type=float, default=None,
                    help="open-loop SLO-window seconds (phase anchor for "
                         "'@k:frac%%' clauses); default: one admission "
                         "quota's estimated drain time")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the run's headline metrics (throughput, "
                         "p50/p99 TTFT, shed rate, joined replicas, "
                         "coordination-plane stats) as JSON")
    add_trace_args(ap)
    ap.add_argument("--tuned", action="store_true",
                    help="apply the tuned-substrate env profile "
                         "(launch/env.py; LD_PRELOAD needs a wrapper that "
                         "evals 'python -m repro_torch.launch.env "
                         "--export')")
    ap.add_argument("--device", default=None,
                    help="torch device the engines run on (default: cuda; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args()
    apply_env(args)

    cfg = get_config(args.arch, reduced=True)
    model = Model(cfg, device=args.device)
    params = model.init(0)
    fleet = FleetSpec.parse(args.fleet, prefix="r")
    if args.coordinators is not None:
        fleet = fleet.with_coordinators(args.coordinators)
    scenario = Scenario.from_arg(args.scenario, fleet.names[0])

    requests = make_requests(args.requests, cfg.vocab_size, args.max_new)
    tracer = make_tracer(args)
    cluster = Cluster(fleet, backend=make_backend(args), trace=tracer,
                      device=args.device)
    names = ", ".join(f"{w.name}={w.perf:g}steps/s x{w.concurrency}slots"
                      for w in fleet.workers)
    print(f"fleet: {names}  (queue depth {args.queue_depth}/replica, "
          f"scenario {scenario or 'none'})")
    rep = cluster.serve(
        ServeJob(requests, model=model, params=params, max_seq=args.max_seq,
                 max_queue_depth=args.queue_depth, overflow=args.overflow,
                 deadline_s=args.deadline, window_s=args.window),
        scenario=scenario,
    )
    for p in rep.phases:
        print(f"{p.label} {p.index}: {p.metrics['n_requests']:3d} reqs  "
              f"{int(p.work):4d} tokens  {p.sim_time_s:7.2f}s  "
              f"{p.metrics['tokens_per_s']:7.2f} tok/s  "
              f"quality={p.quality:.2f}  migrated={p.n_migrated}  "
              f"shares={dict(p.shares)}")
    print(f"served {rep.metrics['n_requests']} requests: "
          f"{int(rep.work_done)} tokens in {rep.sim_time_s:.2f}s -> "
          f"{rep.throughput:.2f} tok/s "
          f"(worst quality {rep.homogenization_quality():.2f}, "
          f"{rep.measured_speedup:.2f}x measured vs "
          f"{rep.predicted_speedup:.2f}x predicted speedup)")
    if rep.latency is not None:
        lat = rep.latency
        print(f"open-loop latency: p50 TTFT {lat.p50_ttft_s:.3f}s, "
              f"p99 TTFT {lat.p99_ttft_s:.3f}s, "
              f"p50 per-token {lat.p50_token_s:.4f}s; "
              f"shed {rep.metrics['n_shed']}/{rep.metrics['n_requests']} "
              f"({lat.shed_rate:.1%})"
              + (f", goodput {lat.goodput_rps:.2f} req/s under "
                 f"{lat.deadline_s:g}s deadline" if lat.deadline_s else "")
              + (f", autoscaled in {rep.metrics['joined']}"
                 if rep.metrics.get("joined") else ""))
    if rep.metrics.get("mode") == "disaggregated":
        split = rep.metrics["ttft_split"]
        rq = rep.metrics["role_quality"]
        print(f"disaggregated: {rep.metrics['n_handoffs']} KV handoffs; "
              f"quality prefill={rq['prefill']:.2f} decode={rq['decode']:.2f}")
        if split:
            parts = "  ".join(
                f"{k[:-2]}={split[k]['mean']:.3f}s"
                for k in ("queue_s", "prefill_s", "handoff_s", "decode_s")
            )
            print(f"TTFT split (mean): {parts}")
    if rep.coord is not None:
        print(f"coordination plane: {rep.coord.summary()}")
    if args.json:
        import json

        payload = {
            "fleet": rep.fleet,
            "scenario": rep.scenario,
            "mode": rep.metrics.get("mode", "waves"),
            "tokens_per_s": rep.throughput,
            "quality": rep.homogenization_quality(),
            "n_requests": rep.metrics["n_requests"],
            # Coordination-plane stats (sharded dispatch): gossip staleness,
            # cross-shard steals, takeovers — None on single-coordinator runs.
            "coord": rep.coord.as_dict() if rep.coord is not None else None,
        }
        if rep.telemetry is not None:
            payload["telemetry"] = rep.telemetry
        if rep.latency is not None:
            payload.update(
                p50_ttft_s=rep.latency.p50_ttft_s,
                p99_ttft_s=rep.latency.p99_ttft_s,
                shed_rate=rep.latency.shed_rate,
                goodput_rps=rep.latency.goodput_rps,
                joined=list(rep.metrics.get("joined", [])),
            )
        if rep.metrics.get("mode") == "disaggregated":
            payload.update(
                ttft_split=rep.metrics["ttft_split"],
                role_quality=rep.metrics["role_quality"],
                role_shares=rep.metrics["role_shares"],
                n_handoffs=rep.metrics["n_handoffs"],
            )
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2)
        print(f"wrote {args.json}")
    export_trace(tracer, args)

    if args.compare_serial:
        serial = Cluster(fleet, backend=make_backend(args),
                         device=args.device).serve(
            ServeJob(make_requests(args.requests, cfg.vocab_size, args.max_new),
                     model=model, params=params, max_seq=args.max_seq,
                     max_queue_depth=args.queue_depth, batched=False),
            scenario=scenario,
        )
        print(f"serial baseline: {serial.throughput:.2f} tok/s -> batched "
              f"speedup {rep.throughput / serial.throughput:.2f}x")


if __name__ == "__main__":
    main()
