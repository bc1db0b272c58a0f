"""Serving with homogenized dispatch + a real continuous-batching fleet,
through the declarative Cluster API.

Port of ``examples/serve_hetero.py``, on the card unless ``--device cpu``.

Part 1 — one real DecodeEngine (continuous batching over a tiny LM): requests
of different lengths stream through a fixed slot pool; finished sequences are
replaced immediately.

Part 2 — batched fleet serving: three replicas of unequal step clocks *and*
slot counts described by one ``FleetSpec`` string.  Engines are first-class
runtime executors: slots stay full, durations are measured engine-step
counts, heartbeats are measured tokens/sec.  The same request set through the
per-request-serial path shows what slot-level batching buys.

Part 3 — the tentpole scenario on real engines, scripted in the Scenario DSL:
``halve:r-fast@20%`` halves a replica's step clock mid-bundle.  The static
one-shot plan finishes at the straggler's pace; the runtime migrates
unstarted requests off the degraded replica and holds the homogenization line
(quality <= 1.3).

The tokens/s, quality and shares are the sim clock's (engine-step counts),
so they are the reference's; the tokens come from the port's own random
weights.  As in the reference, every request enters its engine through
``submit`` (its prompt fed through decode steps): no prefill runs, so no
kernel of the port is on this example's path.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_hetero [--device cpu]
      ... --trace serve.json   # open at https://ui.perfetto.dev
"""

import argparse

from ..cluster import Cluster, FleetSpec, ServeJob
from ..models import LayerSpec, Model, ModelConfig
from ..obs import Tracer
from ..serve import DecodeEngine, Request

FLEET = FleetSpec.parse("r-fast=8x4,r-mid=4x2,r-slow=2x1")


def demo_model(device=None):
    cfg = ModelConfig(
        name="serve-demo", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=128, head_dim=16,
        layer_pattern=(LayerSpec("attn", "dense"),),
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
        rope_theta=1e4,
    )
    model = Model(cfg, device=device)
    return model, model.init(0)


def mk_requests(n, max_new=6):
    return [
        Request(rid=i, prompt=[1 + i % 9, 2, 3 + i % 5],
                max_new_tokens=max_new)
        for i in range(n)
    ]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the Part 3 adaptive run's grain-lifecycle "
                         "trace as Perfetto trace_event JSON (or JSONL when "
                         "PATH ends in .jsonl)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    model, params = demo_model(args.device)

    # ---------------- Part 1: continuous batching on a real engine ----------
    eng = DecodeEngine(model, params, max_batch=4, max_seq=64,
                       device=args.device)
    reqs = [
        Request(rid=i, prompt=[1 + i, 2, 3 + i % 5], max_new_tokens=4 + 3 * (i % 3))
        for i in range(10)
    ]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    print("== continuous batching (1 replica, 4 slots, 10 requests) ==")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt={r.prompt} -> {r.out_tokens} "
              f"(finished @engine-step {r.finish_step})")
    print(f"engine steps={eng.steps} tokens_out={eng.tokens_out} "
          f"(tokens/step={eng.throughput:.2f} — continuous batching keeps slots busy)")

    # ------------- Part 2: batched fleet vs per-request-serial --------------
    print(f"\n== batched fleet serving (fleet: {FLEET}) ==")

    def job(reqs, **kw):
        # Fresh cluster per measurement: reused engines would carry
        # unconsumed step/token counters into the first measured heartbeat.
        return ServeJob(reqs, model=model, params=params, max_seq=64,
                        max_queue_depth=kw.pop("max_queue_depth", 16), **kw)

    serial = Cluster(FLEET, device=args.device).serve(
        job(mk_requests(24), batched=False))
    batched = Cluster(FLEET, device=args.device).serve(job(mk_requests(24)))
    print(f"serial : {serial.throughput:7.2f} tok/s "
          f"(one request per grain, engines drained at completion)")
    print(f"batched: {batched.throughput:7.2f} tok/s  shares="
          f"{dict(batched.phases[0].shares)}")
    print(f"slot-level continuous batching buys "
          f"{batched.throughput / serial.throughput:.2f}x fleet tokens/sec")

    # -------- Part 3: mid-bundle degradation, adaptive vs static ------------
    print("\n== r-fast's step clock halves mid-bundle (48 requests) ==")
    results = {}
    tracer = Tracer() if args.trace else None
    for label, homogenize in (("async runtime", True),
                              ("equal-split static", False)):
        # Only the adaptive run is traced: its Perfetto view is the demo —
        # migration flow arrows carrying requests off the halved r-fast.
        cluster = Cluster(FLEET, homogenize=homogenize,
                          trace=tracer if homogenize else None,
                          device=args.device)
        cluster.serve(job(mk_requests(48), max_queue_depth=32))  # warm wave
        reqs = mk_requests(48)
        rep = cluster.serve(job(reqs, max_queue_depth=32),
                            scenario="halve:r-fast@20%")
        p = rep.phases[0]
        results[label] = rep
        print(f"{label:16s}: {p.metrics['tokens_per_s']:7.2f} tok/s "
              f"quality={p.quality:.3f} migrated={p.n_migrated} "
              f"shares={dict(p.shares)}")
        if not all(r.done for r in reqs):
            raise SystemExit(f"{label}: requests left unfinished")
    ada = results["async runtime"].homogenization_quality()
    sta = results["equal-split static"].homogenization_quality()
    print(f"re-homogenization holds the line: quality {sta:.2f} -> {ada:.2f}")
    if not (ada <= 1.3 and ada < sta):
        raise SystemExit(f"quality {ada:.3f} (static {sta:.3f}): the "
                         "homogenization line does not hold")
    if tracer is not None:
        n_moves = sum(1 for e in tracer.events
                      if e.kind in ("migrate", "steal") and e.worker == "r-fast")
        n = tracer.export(args.trace)
        print(f"wrote {n} trace events to {args.trace} "
              f"({n_moves} requests moved off r-fast; open at "
              f"https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
