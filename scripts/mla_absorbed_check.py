#!/usr/bin/env python3
"""DeepSeek-V2's absorbed MLA decode against its decompressed prefill, layer
by layer, on the card.

    python3 scripts/mla_absorbed_check.py [--layers N] [--dtype D] [--t T]

Run from the repository root on the machine with the card.  Builds
``deepseek-v2-236b`` at its published widths, cut to ``--layers`` (the
dense first layer, then MoE layers), in ``--dtype`` (params and compute),
from ``Model.init(0)``, with MoE capacities that drop nothing.  Prefills
``T`` seeded tokens, writes the caches into a decode cache, and runs
``decode_step`` on token ``T`` at position ``T``; separately prefills the
``T + 1`` tokens.  Prints one JSON line: for each layer, the largest
absolute difference of its output at position ``T`` between the two forms
over the output's largest magnitude, and for each MoE layer whether the
top-k experts of token ``T`` agree; and the logits' largest difference and
greedy tokens, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--t", type=int, default=100)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("mla_absorbed_check: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import Model, moe, transformer
    from repro_torch.serve.engine import _put

    dev = torch.device("cuda")
    cfg = get_config("deepseek-v2-236b", n_layers=args.layers,
                     param_dtype=args.dtype, compute_dtype=args.dtype)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
    model = Model(cfg)
    params = model.init(cs.SEED)
    t = args.t
    toks = torch.as_tensor(np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, (1, t + 1)), device=dev)

    outs: list = []
    experts: list = []
    apply_layer, route = transformer.apply_layer, moe._route

    def record_layer(*a, **kw):
        x, c, aux = apply_layer(*a, **kw)
        outs.append(x[:, -1].float())
        return x, c, aux

    def record_route(p, m, xt):
        r = route(p, m, xt)
        experts.append(sorted(r[2][-1].tolist()))
        return r

    transformer.apply_layer, moe._route = record_layer, record_route
    try:
        with torch.no_grad():
            whole, _ = model.prefill(params, {"tokens": toks})
            ref_outs, ref_experts = outs[:], experts[:]
            _, pre = model.prefill(params, {"tokens": toks[:, :t]})
            outs.clear(), experts.clear()
            cache = model.init_cache(1, 2 * t)
            for key, full in cache["periods"].items():
                _put(full["self"], pre["periods"][key]["self"], 1, 0)
            for full, part in zip(cache["prefix"], pre["prefix"]):
                _put(full["self"], part["self"], 0, 0)
            outs.clear(), experts.clear()
            step, _ = model.decode_step(params, cache, toks[:, t:], t)
    finally:
        transformer.apply_layer, moe._route = apply_layer, route
    torch.cuda.synchronize()
    layers = [{"layer": i,
               "rel_diff": float((a - b).abs().max() / b.abs().max()),
               "max_abs": float(b.abs().max())}
              for i, (a, b) in enumerate(zip(outs, ref_outs, strict=True))]
    moe_layers = [{"layer": i + 1, "same_experts": a == b}
                  for i, (a, b) in enumerate(zip(experts, ref_experts,
                                                 strict=True))]
    v = cfg.vocab_size
    print(json.dumps({
        "card": cs.card_line(), "layers": args.layers, "dtype": args.dtype,
        "t": t, "by_layer": layers, "moe_routing": moe_layers,
        "logits_max_abs_diff": float((step - whole).abs().max()),
        "logits_max_abs": float(whole.abs().max()),
        "greedy": [int(step[0, -1, :v].argmax()),
                   int(whole[0, -1, :v].argmax())]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
