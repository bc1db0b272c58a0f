#!/usr/bin/env python3
"""The dry run's figures for tensor-parallel compute: an arch's train
cell's ``useful_flops_ratio`` and the ``decode_32k`` cell's collective
bytes a device, on the production (16, 16) mesh.

    PYTHONPATH=src python scripts/dryrun_tp_figures.py [--src DIR]
        [--arch qwen2-1.5b] [--batch 16] [--seq 1024]

On the CPU, no card: ``launch.dryrun.measure`` runs one sharded step on
fake tensors under a fake process group of 256 ranks, so every figure is
the dry run's prediction, not a device number.  The train cell is
``train_4k`` cut to ``--batch`` sequences of ``--seq`` tokens (the whole
cell takes the plain chunked attention over 256 x 4096 tokens); the
decode cell is whole.  ``--src`` imports the port from another checkout's
``src`` (a parent commit unpacked with ``git archive``), so both commits
run the same cells.  ``--arch`` takes any of the registry's archs (at
their published widths; an enc-dec model's train cell counts its decoder
tokens, half the sequence, as ``launch/dryrun.py::run_cell`` does).
Prints one JSON line: each cell's FLOPs a device, model FLOPs, the ratio,
collective bytes a device by operation, the largest collectives and the
peak a device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import measure, model_flops
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.models.model import Model

    cfg = get_config(args.arch)
    mesh = production_mesh_shape()
    out = {"src": os.path.abspath(args.src), "arch": cfg.name,
           "policy": cfg.sharding_policy, "mesh": list(mesh.sizes)}
    cells = {
        "train": dataclasses.replace(SHAPES["train_4k"],
                                     global_batch=args.batch,
                                     seq_len=args.seq),
        "decode_32k": SHAPES["decode_32k"],
    }
    for name, shape in cells.items():
        m = measure(cfg, shape, mesh)
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        if cfg.is_enc_dec and shape.kind != "decode":
            tokens //= 2         # decoder tokens, as launch/dryrun.run_cell

        mf, _ = model_flops(cfg, Model(cfg, device="meta"), shape, tokens,
                            shape.kind)
        coll = m["coll"]
        out[name] = {
            "global_batch": shape.global_batch, "seq_len": shape.seq_len,
            "flops_per_device": m["flops"], "model_flops": mf,
            "useful_flops_ratio": mf / max(m["flops"] * m["n_devices"], 1.0),
            "collective_bytes_per_device": coll["bytes_per_device"],
            "per_op_bytes": coll["per_op_bytes"],
            "per_op_counts": coll["per_op_counts"],
            "top_ops": coll["top_ops"][:6],
            "peak_bytes": m["peak_bytes"], "run_s": round(m["run_s"], 2)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
