#!/usr/bin/env python3
"""Which CUDA graph capture mode captures the training backward, and after
how many warm-ups.

    python3 scripts/train_capture_probe.py [--layers 4] [--seq 1024]

Run from the repository root on the machine with the card.  Qwen2-1.5B at
full width, cut to ``--layers`` layers, seeded weights, one grain of one
``--seq``-token sequence, in bf16 and in f32.  For each dtype it takes the
eager route's loss and gradients (``compile_steps=False``: forward, remat
recompute and backward dispatched from Python, K4's backward kernels
launched from autograd's device thread), then captures the grain gradient
(``train/step.py``'s ``_value_and_grad`` through ``serve/compiled.py``'s
``CompiledStep``) under each capture error mode (``thread_local``, which
``CompiledStep`` uses, ``global``, which PyTorch's whole-network example
uses, and ``relaxed``), after one eager warm-up on the side stream and
after none.  Each capture is replayed twice; the script prints, per case,
whether the capture succeeded (or CUDA's error), whether each replay's
loss and every gradient leaf equal the eager route's bit for bit, the K4
launches each replay adds to ``LAUNCHES`` against the eager call's, the
capture's host seconds and the host ms of a replay (with the wait) against
the eager call's.  The card's name and power limit come first; the last
line is one JSON object of the cases.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_capture_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.data import GrainSpec, SyntheticSource, batch_from_grains
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.serve.compiled import CompiledStep
    from repro_torch.train.step import _value_and_grad
    from repro_torch.tree import tree_leaves

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {card.strip()}", flush=True)
    dev = torch.device("cuda")
    fa.load_library()
    mode_now = {"mode": "thread_local"}
    begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(self, pool=None, capture_error_mode="global"):
        return begin(self, pool=pool, capture_error_mode=mode_now["mode"])

    torch.cuda.CUDAGraph.capture_begin = capture_begin

    def outputs(res):
        (loss, _), grads = res
        return [loss] + tree_leaves(grads)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    cases = []
    for dtype in ("bfloat16", "float32"):
        cfg = get_config("qwen2-1.5b", n_layers=args.layers,
                         param_dtype=dtype, compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, use_pallas=None)
        model = Model(cfg)
        params = model.init(0)
        spec = GrainSpec(1, args.seq, cfg.vocab_size)
        batch = batch_from_grains(SyntheticSource(spec, seed=0), 0, [0], spec,
                                  device=dev)
        keys = tuple(sorted(batch))

        def grain(*xs):
            return _value_and_grad(model, params, dict(zip(keys, xs)))

        before = dict(fa.LAUNCHES)
        want, eager_ms = timed(lambda: outputs(_value_and_grad(
            model, params, batch)))
        eager_k4 = {k: fa.LAUNCHES[k] - before[k] for k in before}
        want = [x.clone() for x in want]
        for mode in ("thread_local", "global", "relaxed"):
            for warmups in (1, 0):
                mode_now["mode"] = mode
                step = CompiledStep(f"probe[{dtype},{mode},{warmups}]", grain,
                                    dev)
                step.calls = 1 - warmups
                row = {"dtype": dtype, "mode": mode, "warmups": warmups,
                       "eager_ms": eager_ms, "eager_k4": eager_k4}
                try:
                    if warmups:
                        step(*(batch[k] for k in keys))
                    bits, k4, replay_ms = [], [], []
                    for _ in range(2 if warmups else 3):
                        before = dict(fa.LAUNCHES)
                        got, ms = timed(lambda: outputs(
                            step(*(batch[k] for k in keys))))
                        k4.append({k: fa.LAUNCHES[k] - before[k]
                                   for k in before})
                        bits.append(all(torch.equal(a, b)
                                        for a, b in zip(got, want,
                                                        strict=True)))
                        replay_ms.append(ms)
                    row.update(captured=step.graph is not None, bitwise=bits,
                               k4=k4, capture_s=step.capture_s,
                               pool_bytes=step.pool_bytes,
                               replay_ms=replay_ms)
                except RuntimeError as err:
                    row.update(captured=False, error=str(err)[:400])
                torch.cuda.synchronize()
                print(f"[probe] {json.dumps(row)}", flush=True)
                cases.append(row)
                del step
        del model, params, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": card.strip(), "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
