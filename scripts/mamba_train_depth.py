#!/usr/bin/env python3
"""How deep a bf16 Mamba2-2.7B (or Qwen2-VL-7B) trains on one card:
chip_smoke.py phase 27's run (or phase 28's) at each depth asked for.

    python3 scripts/mamba_train_depth.py [--arch mamba2-2.7b] [--layers 56 64]
                                         [--compile 1]

Run from the repository root on the machine with the card.  For each
``--layers`` value, in a process of its own (so that one depth's memory
never meets the next's), the arch at its published widths cut to that many
layers, seeded weights, on the compiled route (``--compile 0``: the eager
route).  Mamba2-2.7B (d_model 2560, 80 SSD heads of 64, d_state 128; the
default) trains through ``Cluster("4:3:2:1").train`` for 3 steps of 8 grains
of one 1024-token sequence under ``halve:pod0@1:25%``, K5's forward and
backward on every layer; Qwen2-VL-7B through ``train_single`` on phase 28's
batches (one 1024-token sequence of embeddings with M-RoPE streams that
differ, 3 steps and a fourth), K4 on every layer.  Each depth prints its
parameters, its losses, wall seconds, tokens/s,
``torch.cuda.max_memory_allocated`` and the bytes of the graph pools, or
the out-of-memory error it met; the card's name and power limit come first;
the last line is one JSON object of the depths.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

SEQ, GRAINS, STEPS = 1024, 8, 3


def one_depth_single(arch: str, layers: int, compile_steps: bool) -> dict:
    """Phase 28's ``train_single`` run of ``arch`` at ``layers`` layers."""
    import torch

    sys.path.insert(0, os.path.dirname(HERE))
    import chip_smoke

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, n_layers=layers)
    batches = chip_smoke.train_single_batches(torch, cfg,
                                              torch.device("cuda"))
    t0 = time.perf_counter()
    r = chip_smoke.train_single_route(torch, cfg, batches, compile_steps)
    wall_s = time.perf_counter() - t0
    out = {"arch": arch, "layers": layers, "compile_steps": compile_steps}
    if "oom" in r:
        out.update(error=r["oom"]["error"], peak_gb=r["oom"]["peak_gb"],
                   allocated_gb=r["oom"]["allocated_gb"],
                   held_gb=r["oom"]["held_gb"])
        return out
    out.update(params=r["params"], wall_s=wall_s,
               tokens_s=sum(r["tokens"]) / wall_s, step_s=r["step_s"],
               losses=r["loss"], peak_gb=r["peak_gb"], held_gb=r["held_gb"],
               pool_gb=r["graphs"]["pool_bytes"] / 1e9,
               launches=dict(fa.LAUNCHES))
    return out


def one_depth(layers: int, compile_steps: bool) -> dict:
    import torch

    from repro_torch.cluster import Cluster, FleetSpec, TrainJob
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.models import Model
    from repro_torch.serve import compiled
    from repro_torch.tree import tree_leaves

    model = Model(get_config("mamba2-2.7b", n_layers=layers))
    fleet = FleetSpec.parse("4:3:2:1", prefix="pod")
    out = {"layers": layers, "compile_steps": compile_steps}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rep = Cluster(fleet).train(
            TrainJob(model, steps=STEPS, grains=GRAINS, seq_len=SEQ,
                     compile_steps=compile_steps),
            scenario=f"halve:{fleet.names[0]}@1:25%")
        torch.cuda.synchronize()
    except torch.OutOfMemoryError as err:
        out.update(error=str(err).splitlines()[0],
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        return out
    wall_s = time.perf_counter() - t0
    params = sum(leaf.numel()
                 for leaf in tree_leaves(rep.artifact.state.params))
    out.update(params=params, wall_s=wall_s,
               tokens_s=STEPS * GRAINS * SEQ / wall_s,
               losses=[p.metrics["loss"] for p in rep.phases],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               pool_gb=compiled.STATS["pool_bytes"] / 1e9,
               launches=dict(k5.LAUNCHES))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b",
                    choices=["mamba2-2.7b", "qwen2-vl-7b"])
    ap.add_argument("--layers", type=int, nargs="+", default=[56, 64])
    ap.add_argument("--compile", type=int, default=1)
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        if args.arch == "mamba2-2.7b":
            row = one_depth(args.one, bool(args.compile))
        else:
            row = one_depth_single(args.arch, args.one, bool(args.compile))
        print(json.dumps(row))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("mamba_train_depth: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    rows = []
    for layers in args.layers:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", str(layers),
             "--compile", str(args.compile), "--arch", args.arch],
            capture_output=True, text=True)
        last = proc.stdout.strip().splitlines()
        row = json.loads(last[-1]) if proc.returncode == 0 and last else {
            "layers": layers, "error": proc.stderr.strip()[-2000:]}
        rows.append(row)
        print(f"[depth] {card}: {json.dumps(row)}", flush=True)
    print(json.dumps({"card": card, "depths": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
