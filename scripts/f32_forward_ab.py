#!/usr/bin/env python3
"""Device times of the port's f32 attention forwards, for comparing trees.

    python3 scripts/f32_forward_ab.py [--src DIR] [--label NAME]

Run from the repository root on the machine with the card.  Imports
``repro_torch`` from ``DIR`` (default: this checkout's ``src``; give the
``src`` of another checkout, unpacked under ``_checkout/``, to time that
tree's kernels) and prints one JSON line: the device time per call
(``chip_smoke.device_ms``, the profiler's kernel durations) of K4's f32
forward at the training path's shape (q (16, 1024, 128), k/v (2, 1024,
128), causal) and of K1 in f32 at ``chip_smoke.py`` phase 4's shape (q (16,
128, 128), k/v (2, 128, 128)), each beside PyTorch's SDPA in f32 on the same
inputs (TF32 off), with the card's name and power limit.  To compare two
trees, run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("f32_forward_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.prefill import prefill as pf

    assert os.path.abspath(fa.__file__).startswith(os.path.abspath(args.src))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {"label": args.label, "card": cs.card_line()}
    q, k, v = rand((16, 1024, 128)), rand((2, 1024, 128)), rand((2, 1024, 128))
    out["k4_fwd_f32"] = {
        "device_ms": cs.device_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, group=8)),
        "sdpa_device_ms": cs.device_ms(torch, cs.library_attention(
            torch, q, k, v))}
    hq, hkv, s, d = cs.K1_F32_SHAPE
    q, k, v = rand((hq, s, d)), rand((hkv, s, d)), rand((hkv, s, d))
    out["k1_f32"] = {
        "device_ms": cs.device_ms(torch, lambda: pf.prefill_flash(
            q, k, v, group=hq // hkv)),
        "sdpa_device_ms": cs.device_ms(torch, cs.library_attention(
            torch, q, k, v))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
