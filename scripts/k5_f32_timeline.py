#!/usr/bin/env python3
"""Where K5's f32 kernel spends its time, block by block, on the card.

    python3 scripts/k5_f32_timeline.py

Run from the repository root on the machine with the card.  Builds a copy of
``src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu`` into
``kernels/_build/`` with ``clock64()`` stamps added to
``ssd_scan_f32_kernel`` (thread 0 of each block writes them to a device
array; the copy is built as its own library, ``k5_timeline``, and the
port's library is left as it is), runs it at ``chip_smoke.py`` phase 13's
shape (xdt (80, 128, 64), B/C (1, 128, 128), chunk 256; phase 12's input
recipe, seeded), checks that its output is the port's kernel's bit for bit,
and prints one JSON line: the card's name and power limit, the device time
of the port's kernel and of the stamped copy (``chip_smoke.device_ms``),
and, in SM clock cycles from the block's start, averaged over the blocks:
the end of the prefix sum (warp 0 runs it), the arrival of the last warp
at the first barrier (warps 1-7 stage the first tiles), and for each
(query tile, key tile) step the times after its tiles are in, after the
Gram and its decays, after the scores' barrier, after the product with xdt
and after the state update; then the start and end of the final state's
store.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = 64          # stamps a block
STEPS = 11           # steps stamped, 5 stamps each from index 2


def stamped_source(src: str) -> str:
    """``src`` with thread 0's stamps inserted at fixed anchors."""
    def at(anchor, before="", after=""):
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)

    def stamp(index, cond="tid == 0"):
        return (f"if ({cond}) k5_stamps[blockIdx.x * {STAMPS} + ({index})] = "
                f"clock64() - t_start;\n")

    step = f"tid == 0 && stamp_step < {STEPS}"
    at("  constexpr int kStagers = kF32Threads - 32;",
       before="  const long long t_start = clock64();\n  int stamp_step = 0;\n")
    at("    float hc[CP][NV];                  // this chunk's (xdt w)^T B",
       before="    " + stamp(1, "tid == 0 && c0 == 0")
       + "    " + stamp(STAMPS - 4, "tid == kF32Threads - 1 && c0 == 0"))
    at("                             // reads done\n",
       after="        " + stamp("2 + 5 * stamp_step", step))
    at("        __syncthreads();     // the scores and w written; C read\n",
       before="        " + stamp("3 + 5 * stamp_step", step),
       after="        " + stamp("4 + 5 * stamp_step", step))
    at("        // The last query tile sees every key tile: the state's new "
       "sum.\n", before="        " + stamp("5 + 5 * stamp_step", step))
    at("      }\n      // y, with the inter-chunk term after the first chunk.\n",
       before="        " + stamp("6 + 5 * stamp_step", step)
       + "        ++stamp_step;\n")
    at("  // The final state from its transposed copy",
       before="  " + stamp(STAMPS - 3))
    at("}\n\ntemplate <int NP>\ncudaError_t launch_f32",
       before="  " + stamp(STAMPS - 1))
    at("namespace {\n\nconstexpr int kMaxN",
       before=f"__device__ long long k5_stamps[160 * {STAMPS}];\n\n")
    return src + f"""
extern "C" int k5_read_stamps(long long* host, int blocks) {{
  return (int)cudaMemcpyFromSymbol(host, k5_stamps,
                                   sizeof(long long) * {STAMPS} * blocks);
}}
"""


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("k5_f32_timeline: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import BUILD_DIR, build_library
    from repro_torch.kernels.mamba_scan import mamba_scan as k5

    (src_path,) = k5.SOURCES
    with open(src_path) as f:
        text = stamped_source(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    copy = os.path.join(BUILD_DIR, "k5_timeline.cu")
    with open(copy, "w") as f:
        f.write(text)
    lib = ctypes.CDLL(build_library("k5_timeline", [copy], k5.HEADERS))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan.argtypes = [vp] * 6 + [i32] * 7 + [vp]
    lib.ssd_scan.restype = i32

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev)

    h, g, s, p, n, chunk = cs.K5_F32_SHAPE
    dtv = rand((h, s)).abs() * 0.1 + 0.01
    xdt = rand((h, s, p)) * dtv[..., None]
    la = dtv * -(rand((h,)).abs() + 0.1)[:, None]
    bg, cg = rand((g, s, n)), rand((g, s, n))

    def stamped():
        y = torch.empty_like(xdt)
        state = torch.empty((h, p, n), device=dev)
        err = lib.ssd_scan(xdt.data_ptr(), la.data_ptr(), bg.data_ptr(),
                           cg.data_ptr(), y.data_ptr(), state.data_ptr(), h,
                           s, p, n, chunk, h // g, 0,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"stamped K5 launch failed: CUDA error {err}")
        return y, state

    want = k5.ssd_scan(xdt, la, bg, cg, chunk=chunk, rep=h // g)
    got = stamped()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (STAMPS * h))()
    if lib.k5_read_stamps(buf, h):
        raise RuntimeError("could not read the stamps")
    rows = [buf[b * STAMPS:(b + 1) * STAMPS] for b in range(h)]

    def mean(i):
        return statistics.mean(r[i] for r in rows)

    n_steps = sum(1 for qi in range(0, s, 64) for _ in range(0, qi + 1, 64))
    out = {
        "card": cs.card_line(),
        "shape": {"xdt": [h, s, p], "bc": [g, s, n], "chunk": chunk},
        "bitwise_equal_to_the_port_kernel": bool(
            torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
        "device_ms": cs.device_ms(torch, lambda: k5.ssd_scan(
            xdt, la, bg, cg, chunk=chunk, rep=h // g)),
        "stamped_device_ms": cs.device_ms(torch, stamped),
        "cycles": {
            "prefix_end": mean(1),
            "last_warp_at_first_barrier": mean(STAMPS - 4),
            "steps": [{k: mean(2 + 5 * t + i) for i, k in enumerate(
                ("tiles_in", "gram", "scores_barrier", "s_xdt", "state"))}
                for t in range(min(n_steps, STEPS))],
            "state_store_start": mean(STAMPS - 3),
            "end": mean(STAMPS - 1)}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
