"""End-to-end driver: train an LM with runtime-driven Homogenized Data
Parallelism, through the declarative Cluster API.

Port of ``examples/train_hetero.py``, on the card unless ``--device cpu``
(each grain's forward and backward through K4 there).

Four simulated pods with heterogeneous throughput (one ``FleetSpec`` string)
train one model; each step's microbatch grains stream through the async
runtime, every grain completion is a heartbeat, and the coordinator re-allots
work *within* the step.  The fault script is one Scenario DSL string: pod1
throttles 5x **mid-step** a third of the way in (watch unstarted grains
migrate off it the same step), then pod3 dies outright at two thirds (elastic
replan).  A checkpoint/restart at the end proves fault-tolerant resume: the
restarted coordinator plans from the checkpointed *learned* perf vector, not
neutral priors.  Step times, quality, migrations and plans are the sim
clock's, so they are the reference's; the losses come from the port's own
random weights.

Run:      PYTHONPATH=src python -m repro_torch.examples.train_hetero [--device cpu]
Bigger:   ... --d-model 768 --layers 12 --steps 300
"""

import argparse
import math
import shutil
import tempfile

from ..cluster import Cluster, FleetSpec, TrainJob
from ..models import LayerSpec, Model, ModelConfig
from ..optim import AdamWConfig
from ..tree import tree_leaves

FLEET = FleetSpec.parse("pod0=4,pod1=3,pod2=2,pod3=1")


def build_model(d_model: int, layers: int, vocab: int, device=None) -> Model:
    return Model(
        ModelConfig(
            name="hdp-lm", n_layers=layers, d_model=d_model,
            n_heads=max(2, d_model // 64), n_kv_heads=max(2, d_model // 128),
            d_ff=d_model * 4, vocab_size=vocab, head_dim=32,
            layer_pattern=(LayerSpec("attn", "dense"),),
            param_dtype="float32", compute_dtype="float32",
            use_pallas=True, rope_theta=1e4,
        ),
        device=device,
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grains", type=int, default=16)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro_hdp_ckpt_")
    shutil.rmtree(ckpt, ignore_errors=True)

    # The reference runs its plain path here (use_pallas=False) on the
    # CPU; the port's grains go through K4 on the card.
    model = build_model(args.d_model, args.layers, args.vocab, args.device)
    n_params = sum(math.prod(p.shape)
                   for p in tree_leaves(model.abstract_params()))
    print(f"model: {n_params/1e6:.1f}M params")

    straggle_at = args.steps // 3
    kill_at = 2 * args.steps // 3
    # pod1 throttles 5x once step `straggle_at` is ~30% done (mid-step —
    # its unstarted grains migrate the same step); pod3 dies at `kill_at`.
    scenario = (f"degrade:pod1*0.2@{straggle_at}:30%;"
                f"kill:pod3@{kill_at}:0%")
    print(f"fleet: {FLEET}\nscenario: {scenario}")

    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=20, decay_steps=args.steps,
                      weight_decay=0.0)
    job = TrainJob(
        model, steps=args.steps, grains=args.grains, seq_len=args.seq,
        vocab_size=args.vocab, opt=opt, ckpt_dir=ckpt,
        ckpt_every=min(50, max(1, args.steps // 4)),
    )
    try:
        rep = Cluster(FLEET, device=args.device).train(job, scenario=scenario)
        for p in rep.phases:
            if p.index % 20 == 0 or p.index in (straggle_at, kill_at,
                                                args.steps - 1):
                plan = " ".join(f"{k}:{v}" for k, v in p.shares.items())
                print(
                    f"step {p.index:4d} loss={p.metrics['loss']:.4f} "
                    f"step_time={p.sim_time_s:6.2f}s q={p.quality:.2f} "
                    f"mig={p.n_migrated} plan[{plan}]"
                )
        print(rep.summary())

        print("\n--- simulated restart from checkpoint ---")
        # The restarted coordinator re-declares the fleet as it now stands
        # (pod1 slow, pod3 gone) and resumes from the checkpoint's learned
        # perfs.
        rep2 = Cluster("pod0=4,pod1=0.6,pod2=2", device=args.device).train(
            TrainJob(model, steps=args.steps + 10, grains=args.grains,
                     seq_len=args.seq, vocab_size=args.vocab, opt=opt,
                     ckpt_dir=ckpt)
        )
    finally:
        if args.ckpt is None:
            shutil.rmtree(ckpt, ignore_errors=True)
    tr2 = rep2.artifact
    p = tr2.plan_preview()
    print(f"resumed at step {rep2.metrics['start_step']}; plans from LEARNED "
          "perfs: " + " ".join(f"{w}:{s}" for w, s in zip(p.workers, p.shares)))
    print(f"post-restart loss={rep2.metrics['final_loss']:.4f} "
          "(finite => state intact)")
    if not math.isfinite(rep2.metrics["final_loss"]):
        raise SystemExit("post-restart loss is not finite")

    first = rep.metrics["first_loss"]
    last = rep.metrics["final_loss"]
    print(f"\nloss {first:.4f} -> {last:.4f} "
          f"({'OK: decreased' if last < first else 'WARN: did not decrease'})")


if __name__ == "__main__":
    main()
