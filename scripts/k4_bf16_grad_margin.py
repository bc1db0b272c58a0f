#!/usr/bin/env python3
"""Margins of K4's bf16 backward at the training path's shape, by seed.

    python3 scripts/k4_bf16_grad_margin.py [--seeds N]

Run from the repository root on the machine with the card.  For each seed
0 .. N-1, draws q (16, 1024, 128), k and v (2, 1024, 128) and dO as
``chip_smoke.py`` phase 10 draws its inputs (a CUDA generator, normals in
f32 rounded to bf16), runs K4's forward and backward (causal, group 8)
through the autograd function the model calls, and measures each of dQ,
dK and dV against two references on the same bf16 values:

  - ``plain_bf16``: autograd through the plain version on the bf16 leaves
    (what phase 10's main cases hold the kernels against; it rounds P, each
    head's dK and dV and the group's sum to bf16 on the way),
  - ``exact``: autograd through the plain version in f32 on the same values
    (what phase 10's tile-edge cases hold the kernels against),

and the bf16 plain version itself against ``exact``.  A margin is the
largest |got - want| / (atol + rtol |want|) at the bf16 GRAD_TOL (2e-2 /
2e-2): above 1 is outside the tolerance; ``outside`` counts such elements.
Prints one JSON line a seed and a summary, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("k4_bf16_grad_margin: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    rtol, atol = cs.GRAD_TOL["bfloat16"]

    def margin(got, want):
        err = (got.float() - want.float()).abs()
        bound = atol + rtol * want.float().abs()
        return {"margin": float((err / bound).max()),
                "outside": int((err > bound).sum()),
                "max_abs_err": float(err.max())}

    worst = {}
    for seed in range(args.seeds):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def rand(shape, dtype):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)

        q = rand((16, cs.TRAIN_SEQ, 128), torch.bfloat16)
        k = rand((2, cs.TRAIN_SEQ, 128), torch.bfloat16)
        v = rand((2, cs.TRAIN_SEQ, 128), torch.bfloat16)
        dout = rand(q.shape, torch.bfloat16)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads = torch.autograd.grad(fa.flash_attention(*leaves, group=8),
                                    leaves, dout)
        plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plain_grads = torch.autograd.grad(
            flash_attention_ref(*plain, group=8), plain, dout)
        exact = [t.float().requires_grad_(True) for t in (q, k, v)]
        exact_grads = torch.autograd.grad(
            flash_attention_ref(*exact, group=8), exact, dout.float())
        row = {"seed": seed}
        for name, g, p, e in zip(("dq", "dk", "dv"), grads, plain_grads,
                                 exact_grads, strict=True):
            row[name] = {"kernel_vs_plain_bf16": margin(g, p),
                         "kernel_vs_exact": margin(g, e),
                         "plain_bf16_vs_exact": margin(p, e)}
            for key, m in row[name].items():
                w = worst.setdefault(f"{name} {key}", {"margin": 0.0,
                                                       "outside": 0,
                                                       "seeds_outside": 0})
                w["margin"] = max(w["margin"], m["margin"])
                w["outside"] += m["outside"]
                w["seeds_outside"] += int(m["outside"] > 0)
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": cs.card_line(), "seeds": args.seeds,
                      "shape": [[16, cs.TRAIN_SEQ, 128],
                                [2, cs.TRAIN_SEQ, 128]],
                      "tolerance": [rtol, atol], "worst": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
