#!/usr/bin/env python3
"""How far two unsharded bf16 routes of one model drift apart with depth.

    python3 scripts/bf16_depth_spread.py [--arch NAME ...] [--out FILE]

Run from the repository root on the machine with the card (it builds K1
and K5 from this checkout).  For each full-width config of
``chip_smoke.py`` phase 26's bf16 cases (``--arch`` picks some), cut to
each depth below (SeamlessM4T-medium's encoder and decoder both), the
model from one seeded init serves phase 26's prompts
(``chip_smoke.tp_serve``: a prefill, of an enc-dec model over
``chip_smoke.tp_src``'s frames, and 16 greedy decode steps) twice:
through the kernels (K1, K4, K5) and on the plain path
(``use_pallas=False``).
Nothing differs between the two but the order of their roundings.  Prints
one JSON line a depth (and appends it to ``--out`` where one is given):

- ``prefill`` and ``logits0``: the relative Frobenius error of the plain
  route's logits against the kernel route's, the prefill's last positions
  and the first decode step's;
- ``tokens_equal``: the decode tokens both routes give alike, of all;
- ``route_flips`` (MoE configs, capacity drops on as configured): for each
  MoE layer of the prefill, the tokens whose top-k expert sets differ
  between the routes, and ``tokens`` the prefill's token count.

The errors' growth with depth is what a bf16 check between two orders of
the same sums has to allow for; ``chip_smoke.py`` phase 26 takes its depth
cut for Mamba2-2.7B, its limits for the MoE cases and its check of
SeamlessM4T-medium whole from these lines.
The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (config, prompt lengths, bucket, depths): phase 26's (d), (f), (g) and
#: (i).
CASES = (
    ("mamba2-2.7b", (100,), 128, (1, 2, 4, 8, 16, 24, 32, 64)),
    ("qwen2-moe-a2.7b", (20, 90, 300, 500), 512, (1, 2, 4, 8, 24)),
    ("jamba-v0.1-52b", (20, 90, 300, 500), 512, (8,)),
    ("seamless-m4t-medium", (20, 90, 300, 500), 512, (1, 2, 4, 8, 12)),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", choices=[c[0] for c in CASES],
                    default=[c[0] for c in CASES])
    ap.add_argument("--out", default=None,
                    help="a file to append each JSON line to as well")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    if not torch.cuda.is_available():
        print("bf16_depth_spread: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    dev = torch.device("cuda")

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    for name, lengths, bucket, depths in CASES:
        if name not in args.arch:
            continue
        for depth in depths:
            cfg = get_config(name, n_layers=depth)
            if cfg.is_enc_dec:
                cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                    cfg.encoder, n_layers=depth))
            params = Model(cfg).init(cs.SEED)
            tokens, last = cs.tp_prompts(torch, dev, cfg.vocab_size, lengths,
                                         bucket)
            src = (cs.tp_src(torch, dev, cfg, len(lengths)) if cfg.is_enc_dec
                   else None)
            runs = {}
            for route, c in (("kernel", cfg),
                             ("plain", dataclasses.replace(
                                 cfg, use_pallas=False))):
                with cs.keep_routes(tokens.numel()) as routes:
                    plg, logits, toks = cs.tp_serve(torch, Model(c), params,
                                                    tokens, last, src=src)
                torch.cuda.synchronize()
                runs[route] = (plg[..., :cfg.vocab_size].float(),
                               logits[0][..., :cfg.vocab_size], toks, routes)
            (kp, kl, kt, kr), (pp, pl, pt, pr) = runs["kernel"], runs["plain"]
            pairs = [(a, b) for ra, rb in zip(kt, pt, strict=True)
                     for a, b in zip(ra, rb, strict=True)]
            line = {"card": card, "config": name, "layers": depth,
                    "dtype": cfg.compute_dtype, "prompts": list(lengths),
                    "bucket": bucket, "prefill": rel(pp, kp),
                    "logits0": rel(pl, kl),
                    "tokens_equal": [sum(a == b for a, b in pairs),
                                     len(pairs)]}
            if kr:
                line.update(tokens=tokens.numel(),
                            route_flips=cs.route_flips(pr, kr))
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            del params, runs, kp, kl, pp, pl
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
