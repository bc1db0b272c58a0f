#!/usr/bin/env python3
"""How deep a bf16 Mamba2-2.7B (or Qwen2-VL-7B) trains on one card:
chip_smoke.py phase 27's run (or phase 28's) at each depth asked for.

    python3 scripts/mamba_train_depth.py [--arch mamba2-2.7b] [--layers 56 64]
                                         [--compile 1] [--snapshot]
                                         [--src DIR]

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
``torch.cuda.max_memory_allocated`` and ``max_memory_reserved`` beside the
card's memory, and the bytes of the graph pools, or
the out-of-memory error it met; the card's name and power limit come first;
the last line is one JSON object of the depths.  Mamba2's rows also give
the bytes of one gradient tree and the most grains the combine held
waiting at once in a step.

``--snapshot`` records the allocator's history
(``torch.cuda.memory._record_memory_history``) and adds, by owner, the
bytes allocated at the peak (the history replayed) and the bytes reserved
at the end or where the run ran out of memory (``_snapshot``'s segments):
``owners``.  An owner is the graph whose capture allocated the block
(``graph:<step>``) or the general pool, and within it the code that
allocated it (``OWNERS``).  ``--src DIR`` imports the port from ``DIR``
(another tree's ``src``, unpacked under ``_checkout/``) to compare trees.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
if "--src" in sys.argv:
    SRC = os.path.abspath(sys.argv[sys.argv.index("--src") + 1])
sys.path.insert(0, SRC)

SEQ, GRAINS, STEPS = 1024, 8, 3
#: (file, function or None, owner): a block's owner is that of the rule
#: its innermost allocating frame that matches one names; a block that
#: remat's recompute allocated is that recompute's, one with no port frame
#: other port code's, one with no Python frame autograd's device thread's.
OWNERS = (
    ("train/loop.py", "add", "waiting grains (combine copies)"),
    ("train/loop.py", "_fold", "folded sum (and the fold's x * w)"),
    ("optim/adamw.py", "init_opt_state", "moments"),
    ("optim/adamw.py", "_sum_squares", "global_norm"),
    ("optim/adamw.py", "global_norm", "global_norm"),
    ("optim/adamw.py", "upd", "new parameters (an update not in place)"),
    ("optim/adamw.py", None, "AdamW temporaries"),
    ("models/parallel.py", "put", "stacked gradient rows"),
    ("models/transformer.py", "_init_stacked", "parameters"),
    ("models/model.py", "init", "parameters"),
    ("serve/compiled.py", "_fill", "static inputs"),
    ("train/step.py", "_value_and_grad", "grain forward"),
)


def _owner(frames) -> str:
    names = [(f.get("filename", ""), f.get("name", "")) for f in frames]
    if any("torch/utils/checkpoint.py" in file for file, _ in names):
        return "remat recompute"
    for file, name in names:
        for path, fn, owner in OWNERS:
            if path in file and (fn is None or fn == name):
                return owner
    if any("repro_torch/" in file for file, _ in names):
        return "other port code"
    return "backward (autograd thread)" if not frames else "other"


class _Windows:
    """Marks each graph capture's start and end in the allocator's history
    (an allocation made by ``_mark``), so that the blocks allocated in
    between are told to the graph's pool."""

    def __init__(self, torch, compiled):
        self.torch, self.names = torch, []
        run = compiled.CompiledStep._capture
        windows = self

        def capture(step):
            windows.names.append(step.name.split("[")[0])
            windows._mark()
            try:
                return run(step)
            finally:
                windows._mark()

        compiled.CompiledStep._capture = capture

    def _mark(self) -> None:
        self.torch.empty(1, device="cuda")


def owners(torch, windows: _Windows) -> dict:
    """The allocator's history replayed: the bytes live at the peak of
    allocated memory by (pool, owner), and the segments reserved now by
    pool, allocated and cached."""
    snap = torch.cuda.memory._snapshot()
    trace = snap["device_traces"][0]

    def replay(stop: int | None):
        live, total, peak, at, marks, window = {}, 0, 0, 0, 0, None
        for i, ev in enumerate(trace):
            if i == stop:
                break
            act, addr = ev["action"], ev["addr"]
            frames = ev.get("frames", [])
            if act == "alloc" and any(f.get("name") == "_mark"
                                      for f in frames):
                marks += 1
                window = (f"graph:{windows.names[(marks - 1) // 2]}"
                          if marks % 2 else None)
            elif act == "alloc":
                live[addr] = (ev["size"], window or "general", frames)
                total += ev["size"]
                if total > peak:
                    peak, at = total, i + 1
            elif act == "free_completed" and addr in live:
                total -= live.pop(addr)[0]
        return live, peak, at

    _, peak, at = replay(None)
    live = replay(at)[0]
    best: dict = {}
    for size, pool, frames in live.values():
        key = f"{pool} / {_owner(frames)}"
        best[key] = best.get(key, 0) + size
    held: dict = {}
    for seg in snap["segments"]:
        pool = "general" if tuple(seg.get("segment_pool_id", (0, 0))) == \
            (0, 0) else "graph pool"
        h = held.setdefault(pool, [0, 0])
        h[0] += seg["total_size"]
        h[1] += seg["allocated_size"]
    return {"events": len(trace), "peak_gb": peak / 1e9,
            "at_peak_gb": {k: round(v / 1e9, 4) for k, v in
                           sorted(best.items(), key=lambda kv: -kv[1])
                           if v >= 1e7},
            "reserved_gb": {k: {"reserved": round(v[0] / 1e9, 4),
                                "allocated": round(v[1] / 1e9, 4)}
                            for k, v in held.items()}}


def one_depth_single(arch: str, layers: int, compile_steps: bool,
                     snapshot: bool) -> dict:
    """Phase 28's ``train_single`` run of ``arch`` at ``layers`` layers."""
    import torch

    sys.path.insert(0, os.path.dirname(HERE))
    import chip_smoke

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.serve import compiled

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, n_layers=layers)
    batches = chip_smoke.train_single_batches(torch, cfg,
                                              torch.device("cuda"))
    windows = None
    if snapshot:
        windows = _Windows(torch, compiled)
        torch.cuda.memory._record_memory_history(
            "all", context="alloc", stacks="python", max_entries=4_000_000)
    t0 = time.perf_counter()
    r = chip_smoke.train_single_route(torch, cfg, batches, compile_steps)
    wall_s = time.perf_counter() - t0
    out = {"arch": arch, "layers": layers, "compile_steps": compile_steps,
           "src": SRC}
    if snapshot:
        out["owners"] = owners(torch, windows)
    if "oom" in r:
        out.update(error=r["oom"]["error"], peak_gb=r["oom"]["peak_gb"],
                   allocated_gb=r["oom"]["allocated_gb"],
                   held_gb=r["oom"]["held_gb"])
        return out
    out.update(params=r["params"], wall_s=wall_s,
               reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               card_gb=torch.cuda.mem_get_info()[1] / 1e9,
               tokens_s=sum(r["tokens"]) / wall_s, step_s=r["step_s"],
               losses=r["loss"], peak_gb=r["peak_gb"], held_gb=r["held_gb"],
               pool_gb=r["graphs"]["pool_bytes"] / 1e9,
               launches=dict(fa.LAUNCHES))
    return out


def one_depth(layers: int, compile_steps: bool, snapshot: bool) -> dict:
    import torch

    from repro_torch.cluster import Cluster, FleetSpec, TrainJob
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.models import Model
    from repro_torch.serve import compiled
    from repro_torch.train import loop
    from repro_torch.tree import tree_leaves

    # Each step's combine's ``most`` (the most grains waiting at once), read
    # as it hands its sum over; None for a tree (``--src``) without it.
    most = []
    grads = loop._PrefixCombine.grads

    def read_most(self, n_grains):
        most.append(getattr(self, "most", None))
        return grads(self, n_grains)

    loop._PrefixCombine.grads = read_most
    windows = None
    if snapshot:
        windows = _Windows(torch, compiled)
        torch.cuda.memory._record_memory_history(
            "all", context="alloc", stacks="python", max_entries=4_000_000)
    model = Model(get_config("mamba2-2.7b", n_layers=layers))
    fleet = FleetSpec.parse("4:3:2:1", prefix="pod")
    out = {"layers": layers, "compile_steps": compile_steps, "src": SRC}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rep = Cluster(fleet).train(
            TrainJob(model, steps=STEPS, grains=GRAINS, seq_len=SEQ,
                     compile_steps=compile_steps),
            scenario=f"halve:{fleet.names[0]}@1:25%")
        torch.cuda.synchronize()
    except (torch.OutOfMemoryError, RuntimeError) as err:
        if "out of memory" not in str(err):
            raise
        out.update(error=" ".join(str(err).split())[:600],
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   allocated_gb=torch.cuda.memory_allocated() / 1e9,
                   most_waiting=most)
        if snapshot:
            out["owners"] = owners(torch, windows)
        return out
    wall_s = time.perf_counter() - t0
    leaves = tree_leaves(rep.artifact.state.params)
    out.update(params=sum(leaf.numel() for leaf in leaves), wall_s=wall_s,
               tokens_s=STEPS * GRAINS * SEQ / wall_s,
               losses=[p.metrics["loss"] for p in rep.phases],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               card_gb=torch.cuda.mem_get_info()[1] / 1e9,
               pool_gb=compiled.STATS["pool_bytes"] / 1e9,
               grad_tree_gb=sum(x.numel() * x.element_size()
                                for x in leaves) / 1e9,
               most_waiting=most, launches=dict(k5.LAUNCHES))
    if snapshot:
        out["owners"] = owners(torch, windows)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b",
                    choices=["mamba2-2.7b", "qwen2-vl-7b"])
    ap.add_argument("--layers", type=int, nargs="+", default=[56, 64])
    ap.add_argument("--compile", type=int, default=1)
    ap.add_argument("--snapshot", action="store_true")
    ap.add_argument("--src", default=None)
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        if args.arch == "mamba2-2.7b":
            row = one_depth(args.one, bool(args.compile), args.snapshot)
        else:
            row = one_depth_single(args.arch, args.one, bool(args.compile),
                                   args.snapshot)
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
             "--compile", str(args.compile), "--arch", args.arch]
            + (["--snapshot"] if args.snapshot else [])
            + (["--src", SRC] if args.src else []),
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
