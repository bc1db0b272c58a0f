#!/usr/bin/env python3
"""Device times and gradient digests of K5's backward, for comparing trees.

    python3 scripts/k5_bwd_ab.py [--src DIR] [--label NAME]

Run from the repository root on the machine with the card.  Imports
``repro_torch`` from ``DIR`` (default: this checkout's ``src``; give the
``src`` of another checkout, unpacked under ``_checkout/``, to time that
tree's kernels) and prints one JSON line with the card's name and power
limit and, for ``ssd_scan_bwd`` in bf16 and in f32 from seeded inputs
(``chip_smoke.py`` phase 12's recipe, no final-state gradient) at
Mamba2-2.7B's training shape (``chip_smoke.K5_BWD_SHAPE``: xdt (80, 1024,
64), B/C (1, 1024, 128), chunk 256) and at Jamba's
(``chip_smoke.K5_JAMBA_SHAPE``: xdt (128, 512, 64), B/C (1, 512, 16)):
the device time per call (``chip_smoke.device_ms``, the profiler's kernel
durations summed over the call's kernels) and the SHA-256 of dxdt, dla, dB
and dC, so two trees' bits can be compared.

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
        print("k5_bwd_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.mamba_scan import mamba_scan as k5

    assert os.path.abspath(k5.__file__).startswith(os.path.abspath(args.src))
    dev = torch.device("cuda")

    def digest(t):
        return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()[:16]

    out = {"label": args.label, "card": cs.card_line()}
    for name, (h, g, s, p, n, chunk) in (("train", cs.K5_BWD_SHAPE),
                                         ("jamba", cs.K5_JAMBA_SHAPE)):
        for dt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(cs.SEED + 19)

            def rand(shape):
                return torch.randn(shape, generator=gen, device=dev)

            dtv = rand((h, s)).abs() * 0.1 + 0.01
            la = dtv * -(rand((h,)).abs() + 0.1)[:, None]
            xdt = (rand((h, s, p)) * dtv[..., None]).to(dt)
            bg, cg = rand((g, s, n)).to(dt), rand((g, s, n)).to(dt)
            dy = rand((h, s, p)).to(dt)

            def call():
                return k5.ssd_scan_bwd(xdt, la, bg, cg, dy, None,
                                       chunk=chunk, rep=h // g)

            grads = call()
            torch.cuda.synchronize()
            out[f"{name}_{str(dt)[6:]}"] = {
                "device_ms": cs.device_ms(torch, call),
                **{part: digest(v) for part, v in zip(
                    ("dxdt", "dla", "db", "dc"), grads, strict=True)}}
            del xdt, la, bg, cg, dy, grads
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
