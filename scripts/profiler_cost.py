#!/usr/bin/env python3
"""What a profiled serve costs on the host, and two ways to read its busy time.

    python3 scripts/profiler_cost.py [--archs qwen2-moe-a2.7b,mamba2-2.7b]

Run from the repository root on the machine with the card.  For each arch
(full width, bf16, seeded weights) it serves ``chip_smoke.py``'s 8 requests
(5-500 prompt tokens, 16 new tokens each) through
``fast=2.0^prefill,slow=1.0x4^decode`` once unprofiled, then once under
``torch.profiler`` (CPU and CUDA activities), as ``chip_smoke.card_busy``
takes its profiled repeats.  It prints the host seconds of each step: the
unprofiled serve, the profiled serve up to the session's close, summing the
device events' durations from the session's raw events
(``prof.profiler.kineto_results.events()``, what ``card_busy`` reads), and
summing the CUDA rows' ``self_device_time_total`` of
``prof.key_averages()`` (what it read before), with both sums and the
number of raw events.  The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen2-moe-a2.7b,mamba2-2.7b")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cluster import Cluster, ServeJob
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import Request

    if not torch.cuda.is_available():
        print("profiler_cost: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fleet = "fast=2.0^prefill,slow=1.0x4^decode"
    for arch in args.archs.split(","):
        cfg = get_config(arch)
        model = Model(cfg)
        params = model.init(0)
        rng = np.random.default_rng(0)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                   for n in (5, 20, 40, 90, 150, 300, 420, 500)]

        def job() -> ServeJob:
            return ServeJob([Request(rid=i, prompt=list(p), max_new_tokens=16)
                             for i, p in enumerate(prompts)],
                            model=model, params=params, max_seq=1024)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Cluster(fleet).serve(job())
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            Cluster(fleet).serve(job())
            torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = prof.profiler.kineto_results.events()
        raw_busy = sum(e.duration_ns() for e in raw
                       if e.device_type() == DeviceType.CUDA) / 1e9
        raw_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        avg_busy = sum(r.self_device_time_total for r in prof.key_averages()
                       if r.device_type == DeviceType.CUDA) / 1e6
        avg_s = time.perf_counter() - t0
        print(f"{arch}: serve {serve_s:.2f} s; profiled serve {profiled_s:.2f}"
              f" s; raw events {len(raw)}, device sum {raw_busy:.4f} s read "
              f"in {raw_s:.2f} s; key_averages device sum {avg_busy:.4f} s "
              f"read in {avg_s:.2f} s", flush=True)
        del prof, raw, model, params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
