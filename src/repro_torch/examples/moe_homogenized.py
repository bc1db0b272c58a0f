"""Homogenized MoE expert capacity — the paper's scope lengths per expert.

Port of ``examples/moe_homogenized.py``, on the card unless ``--device
cpu``.  Scenario: an MoE layer whose 8 experts run on heterogeneous slices
(e.g. a mixed fleet after elastic rescheduling), so expert throughput
differs 2.5x.  With uniform capacities every expert gets the same token
budget and the slow experts bound the layer's latency.  Homogenized
capacities allot the token budget proportionally to measured expert
throughput — all experts finish together (the homogenization line), at the
cost of a few more drops on slow experts.

We also show the load-skew case on homogeneous hardware: capacities
proportional to *historical expert load* reduce overflow drops vs uniform.
The capacities from the perfs are the reference's; the routing comes from
the port's own random weights.

Run:  PYTHONPATH=src python -m repro_torch.examples.moe_homogenized [--device cpu]
"""

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..models import LayerSpec, ModelConfig, MoEConfig
from ..models.moe import apply_moe, capacity_per_expert, init_moe


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    cfg = ModelConfig(
        name="moe-demo", n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=128, vocab_size=64, head_dim=32,
        layer_pattern=(LayerSpec("attn", "moe"),),
        moe=MoEConfig(n_routed=8, top_k=2, d_expert=64, capacity_factor=1.0),
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
    m = cfg.moe
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_moe(gen, cfg)
    x = torch.as_tensor(rng.standard_normal((8, 64, cfg.d_model)) * 0.5,
                        dtype=torch.float32, device=dev)
    t = x.shape[0] * x.shape[1]

    # --- heterogeneous experts: throughput differs 2.5x ---------------------
    perfs = [1.0, 1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4]
    cap_u = capacity_per_expert(t, m)                       # uniform
    cap_h = capacity_per_expert(t, m, expert_perfs=perfs)   # homogenized
    print("expert perfs      :", perfs)
    print("uniform capacities:", cap_u.tolist())
    print("homog.  capacities:", cap_h.tolist())

    def finish_times(caps):
        return [c / p for c, p in zip(caps, perfs, strict=True)]

    ft_u, ft_h = finish_times(cap_u), finish_times(cap_h)
    print(f"uniform    : worst expert finish={max(ft_u):7.1f} "
          f"(imbalance {max(ft_u)/min(ft_u):.2f}x)")
    print(f"homogenized: worst expert finish={max(ft_h):7.1f} "
          f"(imbalance {max(ft_h)/min(ft_h):.2f}x)  "
          f"=> layer latency -{(1-max(ft_h)/max(ft_u)):.0%}")

    out_u, _ = apply_moe(params, cfg, x, torch.as_tensor(cap_u))
    out_h, _ = apply_moe(params, cfg, x, torch.as_tensor(cap_h))
    print(f"output delta (routing drops differ): "
          f"{float(torch.mean(torch.abs(out_u - out_h))):.2e} mean-abs")

    # --- homogeneous hardware, skewed router: capacity ∝ historical load ----
    print("\n== skewed routing on homogeneous experts ==")
    skew = torch.as_tensor(rng.standard_normal((cfg.d_model, m.n_routed))
                           * 0.02, dtype=torch.float32, device=dev)
    params_skew = dict(params)
    params_skew["router"] = params["router"] + skew * torch.arange(
        m.n_routed, device=dev)
    logits = torch.einsum("td,de->te", x.reshape(t, cfg.d_model),
                          params_skew["router"])
    top1 = torch.argmax(logits, -1).cpu().numpy()
    load = np.bincount(top1, minlength=m.n_routed).astype(float)
    load = np.maximum(load, 1.0)
    print("observed top-1 load:", load.astype(int).tolist())
    cap_load = capacity_per_expert(t, m, expert_perfs=load)
    print("uniform capacities :", capacity_per_expert(t, m).tolist())
    print("load-homogenized   :", cap_load.tolist())

    def drops(caps):
        return int(np.maximum(load * m.top_k - np.asarray(caps), 0).sum())

    print(f"estimated overflow drops: uniform={drops(capacity_per_expert(t, m))} "
          f"homogenized={drops(cap_load)}")


if __name__ == "__main__":
    main()
