"""Training launcher.

Port of ``repro/launch/train.py`` with the same flags, plus ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain versions on the
host).  ``--backend wallclock`` times each grain's real gradient work on
the card (``--devices`` of them, all visible by default); ``--tuned`` raises
until the port slice that brings it.  The reference's description follows.

Two modes:
  --mode single   one-worker training of an assigned arch's *reduced* config
                  (CPU-runnable) or full config (``--full-config``).
  --mode hdp      Homogenized Data Parallel across simulated heterogeneous
                  pods, driven through the declarative Cluster API: ``--fleet``
                  is the FleetSpec grammar (the old ``--pods 4:3:2:1`` perf
                  list is a subset and survives as an alias), ``--scenario``
                  scripts mid-step faults in the Scenario DSL
                  (``halve:pod0@3:25%``, ``kill:pod1@40``...).  Runtime-driven:
                  per-grain heartbeats, mid-step grain migration off
                  stragglers, elastic membership, async checkpoints that carry
                  the learned perf vector.  ``--static`` freezes each step to
                  its initial plan (the non-adaptive baseline).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --mode hdp --fleet 4:3:2:1 \
      --steps 100 --scenario "halve:pod0@30:25%" --ckpt /tmp/hdp_ckpt
"""

from __future__ import annotations

import argparse
import json

from ..cluster import Cluster, FleetSpec, Scenario, TrainJob
from ..configs import ARCH_IDS, get_config
from ..data.pipeline import GrainSpec, SyntheticSource, batch_from_grains
from ..models.model import Model
from ..optim.adamw import AdamWConfig
from ..train.loop import train_single
from .common import (
    add_backend_args,
    add_fleet_arg,
    add_trace_args,
    apply_env,
    export_trace,
    make_backend,
    make_tracer,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--mode", choices=("single", "hdp"), default="single")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (production) config instead of reduced")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grains", type=int, default=8)
    add_fleet_arg(ap, legacy="--pods", default="4:3:2:1",
                  help="hdp fleet in FleetSpec grammar: "
                       "[NAME=]PERF[@PROFILE] per pod, ','/':'-separated, "
                       "optional '/cK' suffix for K coordinator shards")
    add_backend_args(ap)
    ap.add_argument("--coordinators", type=int, default=None,
                    help="shard dispatch across K coordinator replicas "
                         "(overrides the fleet's '/cK' suffix)")
    ap.add_argument("--scenario", default="none",
                    help="hdp fault script: 'none'|'halving'|'kill' or a "
                         "Scenario DSL string, e.g. 'halve:pod0@3:25%%' or "
                         "'ckill:0@1:25%%' (coordinator-shard kill)")
    ap.add_argument("--static", action="store_true",
                    help="hdp: disable mid-step migration/stealing (each step "
                         "runs its initial plan to completion)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="hdp: also write the run's headline metrics (loss, "
                         "step times, quality, coordination-plane stats) "
                         "as JSON")
    add_trace_args(ap)
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--tuned", action="store_true",
                    help="apply the tuned-substrate env profile "
                         "(launch/env.py; LD_PRELOAD needs "
                         "scripts/tuned_run.sh)")
    ap.add_argument("--device", default=None,
                    help="torch device the model trains on (default: cuda; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args()
    apply_env(args)

    cfg = get_config(args.arch, reduced=not args.full_config)
    model = Model(cfg, device=args.device)
    opt = AdamWConfig(peak_lr=args.peak_lr, warmup_steps=max(args.steps // 10, 1),
                      decay_steps=args.steps)

    if args.mode == "single":
        spec = GrainSpec(args.batch, args.seq, cfg.vocab_size)
        src = SyntheticSource(spec)

        if cfg.input_mode != "tokens" or cfg.is_enc_dec:
            from ..configs.shapes import train_batch_specs

            def batch_fn(step):
                return train_batch_specs(cfg, args.batch, args.seq,
                                         device=model.device)
        else:
            def batch_fn(step):
                return batch_from_grains(src, step, [0], spec,
                                         device=model.device)

        _, hist = train_single(
            model, args.steps, batch_fn, opt_cfg=opt, ckpt_dir=args.ckpt,
            log_fn=lambda s, m: print(
                f"step {s:5d} loss={m['loss']:.4f} gnorm={m.get('grad_norm', 0):.3f}"
            ),
        )
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
        return

    fleet = FleetSpec.parse(args.fleet, prefix="pod")
    if fleet.has_roles:
        raise SystemExit(
            "--fleet role suffixes (^prefill/^decode) disaggregate a "
            "*serving* fleet; hdp training takes an all-mixed fleet — "
            "drop the role suffixes or use repro_torch.launch.serve"
        )
    if args.coordinators is not None:
        fleet = fleet.with_coordinators(args.coordinators)
    scenario = Scenario.from_arg(args.scenario, fleet.names[0])
    tracer = make_tracer(args)
    cluster = Cluster(fleet, adaptive=not args.static,
                      backend=make_backend(args), trace=tracer,
                      device=args.device)
    rep = cluster.train(
        TrainJob(model, steps=args.steps, grains=args.grains,
                 seq_len=args.seq, opt=opt, ckpt_dir=args.ckpt,
                 compress_grads=args.compress_grads),
        scenario=scenario,
    )
    for p in rep.phases:
        if p.index % 10 == 0 or p.index == args.steps - 1:
            plan = " ".join(f"{k}:{v}" for k, v in p.shares.items())
            print(f"step {p.index:5d} loss={p.metrics['loss']:.4f} "
                  f"t={p.sim_time_s:.2f}s q={p.quality:.2f} "
                  f"mig={p.n_migrated} plan[{plan}]")
    print(rep.summary())
    if rep.coord is not None:
        print(f"coordination plane: {rep.coord.summary()}")
    if args.json:
        payload = {
            "fleet": rep.fleet,
            "scenario": rep.scenario,
            "steps": rep.n_phases,
            "final_loss": rep.metrics["final_loss"],
            "first_loss": rep.metrics["first_loss"],
            "sim_time_s": rep.sim_time_s,
            "throughput": rep.throughput,
            "quality": rep.homogenization_quality(),
            "n_migrated": rep.n_migrated,
            # Coordination-plane stats (sharded dispatch): gossip staleness,
            # cross-shard steals, takeovers — None on single-coordinator runs.
            "coord": rep.coord.as_dict() if rep.coord is not None else None,
        }
        if rep.telemetry is not None:
            payload["telemetry"] = rep.telemetry
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2)
        print(f"wrote {args.json}")
    export_trace(tracer, args)
    trainer = rep.artifact
    if trainer.ckpt:
        trainer.ckpt.wait()


if __name__ == "__main__":
    main()
