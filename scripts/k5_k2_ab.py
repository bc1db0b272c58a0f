#!/usr/bin/env python3
"""Device times and output digests of K5 in f32 and of K2, for comparing
trees.

    python3 scripts/k5_k2_ab.py [--src DIR] [--label NAME]

Run from the repository root on the machine with the card.  Imports
``repro_torch`` from ``DIR`` (default: this checkout's ``src``; give the
``src`` of another checkout, unpacked under ``_checkout/``, to time that
tree's kernels) and prints one JSON line with the card's name and power
limit and, from seeded inputs (``chip_smoke.py`` phase 12's recipe):

- K5 in f32 at ``chip_smoke.py`` phase 13's shape (xdt (80, 128, 64), B/C
  (1, 128, 128), chunk 256) and at the serving path's (xdt (80, 512, 64),
  B/C (1, 512, 128), chunk 256): the device time per call
  (``chip_smoke.device_ms``, the profiler's kernel durations) and the
  SHA-256 of y and of the state, so two trees' bits can be compared;
- K2 (f32 -> bf16) at phase 3's shape (k and v (2, 128, 128)) and at
  ``chip_smoke.K2_LARGE_SHAPE``: its device time beside ``.to``'s, and
  whether it is ``.to`` bit for bit.

To compare two trees, run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import hashlib
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
        print("k5_k2_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.kernels.prefill import prefill as pf

    assert os.path.abspath(k5.__file__).startswith(os.path.abspath(args.src))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    out = {"label": args.label, "card": cs.card_line()}
    h, g, _, p, n, chunk = cs.K5_F32_SHAPE
    for name, s in (("k5_f32", cs.K5_F32_SHAPE[2]), ("k5_f32_serve", 512)):
        dtv = rand((h, s)).abs() * 0.1 + 0.01
        xdt = rand((h, s, p)) * dtv[..., None]
        la = dtv * -(rand((h,)).abs() + 0.1)[:, None]
        bg, cg = rand((g, s, n)), rand((g, s, n))
        y, state = k5.ssd_scan(xdt, la, bg, cg, chunk=chunk, rep=h // g)
        out[name] = {
            "device_ms": cs.device_ms(torch, lambda: k5.ssd_scan(
                xdt, la, bg, cg, chunk=chunk, rep=h // g)),
            "y": digest(y), "state": digest(state)}
    for name, shape in (("k2", (2, 128, 128)), ("k2_large", cs.K2_LARGE_SHAPE)):
        k, v = rand(shape), rand(shape)
        kc, vc = pf.cache_cast(k, v, torch.bfloat16)
        out[name] = {
            "device_ms": cs.device_ms(torch, lambda: pf.cache_cast(
                k, v, torch.bfloat16)),
            "to_device_ms": cs.device_ms(torch, lambda: (
                k.to(torch.bfloat16), v.to(torch.bfloat16))),
            "bitwise_to": bool(torch.equal(kc, k.to(torch.bfloat16))
                               and torch.equal(vc, v.to(torch.bfloat16)))}
        del k, v, kc, vc
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
