#!/usr/bin/env python3
"""Where K5's backward spends its time, block by block, on the card.

    python3 scripts/k5_bwd_timeline.py [--dtype f32|bf16]

Run from the repository root on the machine with the card.  Builds a copy of
``src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu`` into
``kernels/_build/`` with ``clock64()`` stamps added to the chunk-local
kernel of the dtype (``ssd_bwd_local_kernel`` for f32,
``ssd_bwd_local_mma_kernel`` for bf16; thread 0 of each block writes them
to a device array; the copy is built as its own library, and the port's
library is left as it is), runs the backward at Mamba2-2.7B's training
shape (``chip_smoke.K5_BWD_SHAPE``: xdt (80, 1024, 64), B/C (1, 1024,
128), chunk 256; phase 12's input recipe, seeded), checks that its
gradients are the port's bit for bit, and prints one JSON line: the card's
name and power limit; the device time of the port's backward by kernel
and of the stamped one (``chip_smoke.device_ms``); and, in SM clock
cycles, for the blocks of each 64-row tile t (the key role of tile t takes
nt - t tile pairs, its query role t + 1), averaged over them.  f32: in
each key-role pair the wait for its tiles, the Gram and dY X^T
(``tile_dot``), the decays and scores up to their barrier, and dx's and
dB's products (``rows_times``); the state terms and the writes; in each
query-role step the wait, dY X^T, the decays, and dC's product; the
entering state's term and the writes.  bf16: each pair of the key role's
first pass (G^T, dY X^T, E's sums, dx), the state terms of dx and its
writes, the state term of dB, each pair of the second pass (dY X^T again,
dB), dB's writes, each query-role step, the entering state's term and the
writes.  Both: the whole block.  Per SM: the blocks it ran, their summed
cycles, and the span from its first block's start to its last block's
end (one SM's clock), whose largest value over the SMs is the kernel's
length in cycles.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = 40          # stamps a block
PAIRS = 4            # key-role pairs and query-role steps stamped, 4 each
KEY0, QUERY0 = 3, 21     # their first stamps (4 stamps a pair or step)
STATE, KEYS_END, ENTER = 19, 20, 37
SMID, START, END = 0, 1, 2


# bf16: the first pass's pairs, its end, the state term of dB, its end,
# the second pass's pairs, dB's writes, the query role, its steps, the
# entering state's term.
P1, P1_END, T_TERM, T_END, P2, DB_WRITES, Q_BF16, QS_BF16, ENTER_BF16 = (
    3, 7, 8, 9, 10, 14, 15, 16, 20)


def _splice(src: str, head: str, edits) -> str:
    """``src`` with the kernel that starts at ``head`` edited by ``edits``
    (a function of its body's ``at`` and ``stamp`` helpers), its end
    stamped, and the stamps' array and reader added."""
    a = src.index(head)
    b = src.index("\n}\n", a) + 3
    body = src[a:b]

    def at(anchor, before="", after=""):
        nonlocal body
        if body.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        body = body.replace(anchor, before + anchor + after)

    def stamp(index, cond="tid == 0"):
        return (f"if ({cond}) k5_stamps[k5_block * {STAMPS} + ({index})] = "
                f"clock64() - t_start;\n")

    edits(at, stamp)
    body = body[:-2] + (
        "  if (tid == 0) {\n"
        f"    k5_stamps[k5_block * {STAMPS} + {END}] = clock64() - t_start;\n"
        "    unsigned smid;\n"
        "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
        f"    k5_stamps[k5_block * {STAMPS} + {SMID}] = smid;\n"
        f"    k5_stamps[k5_block * {STAMPS} + {START}] = t_start;\n"
        "  }\n}\n")
    src = src[:a] + body + src[b:]
    anchor = "namespace {\n\nconstexpr int kMaxN"
    if src.count(anchor) != 1:
        raise RuntimeError("anchor for the stamps' array not found once")
    src = src.replace(anchor, f"__device__ long long k5_stamps[2048 * "
                              f"{STAMPS}];\n\n" + anchor)
    return src + f"""
extern "C" int k5_read_stamps(long long* host, int blocks) {{
  return (int)cudaMemcpyFromSymbol(host, k5_stamps,
                                   sizeof(long long) * {STAMPS} * blocks);
}}
"""


STAMP_START = (
    "  const long long t_start = clock64();\n"
    "  const size_t k5_block = blockIdx.x + (size_t)gridDim.x * "
    "(blockIdx.y + (size_t)gridDim.y * blockIdx.z);\n"
    "  int ks_ = 0, qs_ = 0;\n")
KEY = f"tid == 0 && ks_ < {PAIRS}"
QUERY = f"tid == 0 && qs_ < {PAIRS}"


def f32_edits(at, stamp):
    """The stamps of ``ssd_bwd_local_kernel``."""
    key, query = KEY, QUERY
    at("  const float* xp = xdt + pos0 * P;\n", after=STAMP_START)
    at("    __syncthreads();         // this query tile in; the last pair's "
       "reads done\n", after="    " + stamp(f"{KEY0} + 4 * ks_", key))
    at("    tile_dot<kBwdP>(mm, Fp, SX, Yt, SX, tx, ty);    // x_j . dy_i\n",
       after="    " + stamp(f"{KEY0 + 1} + 4 * ks_", key))
    at("    rows_times<T, 4>(dx, Ss, SS, Yt, SX, 4 * tx, ty);\n",
       before="    " + stamp(f"{KEY0 + 2} + 4 * ks_", key))
    at("    rows_times<T, NV>(dbv, Qs, SS, Ct, SF, NV * tx, ty);\n",
       after="    " + stamp(f"{KEY0 + 3} + 4 * ks_", key) + "    ++ks_;\n")
    at("  // The state terms: v_j = dh B_j, t_j = dh^T x_j, r_j = w_j x_j . "
       "v_j.\n", before="  " + stamp(STATE))
    at("  // ---- Queries: rows i of tile t against the key tiles j <= i.\n",
       before="  " + stamp(KEYS_END))
    at("    __syncthreads();         // this key tile in; the last one's "
       "reads done\n", after="    " + stamp(f"{QUERY0} + 4 * qs_", query))
    at("    tile_dot<kBwdP>(mm, Fp, SX, Xt, SX, tx, ty);    // dy_i . x_j\n",
       after="    " + stamp(f"{QUERY0 + 1} + 4 * qs_", query))
    at("    rows_times<T, NV>(dcv, Qs, SS, Bt, SF, NV * tx, ty);\n",
       before="    " + stamp(f"{QUERY0 + 2} + 4 * qs_", query),
       after="    " + stamp(f"{QUERY0 + 3} + 4 * qs_", query) + "    ++qs_;\n")
    at("  // The entering state's terms: u_i = h_in^T dy_i.\n",
       before="  " + stamp(ENTER))


def bf16_edits(at, stamp):
    """The stamps of ``ssd_bwd_local_mma_kernel``."""
    at("  const bf16* xp = xdt + pos0 * P;\n", after=STAMP_START)
    at("    if (k > 0) flush_rows((k - 1) & 1, i0 - T);\n",
       after="    " + stamp(f"{P1} + ks_", KEY) + "    ++ks_;\n")
    at("  // The state terms with dh: v_j = dh B_j (dx), r_j = w_j x_j . "
       "v_j.\n", before="  " + stamp(P1_END) + "  ks_ = 0;\n")
    at("  // Second pass: dB, from its state term",
       before="  " + stamp(T_TERM))
    at("  __syncthreads();           // the state's reads done: its room is "
       "staged\n", before="  " + stamp(T_END))
    at("#pragma unroll 1\n    for (int h = 0; h < 2; ++h) {          // query "
       "columns 32 h .. + 31\n      const int ic = 32 * h;\n      if (k == 0 "
       "&& ic + 31 < warp * 16) continue;",
       before=stamp(f"{P2} + ks_", KEY) + "    ++ks_;\n")
    at("#pragma unroll\n  for (int i = 0; i < 2; ++i) {\n    const int j = i "
       "? rb : ra;\n    if (j >= clen) continue;\n    float* dbr",
       before="  " + stamp(DB_WRITES))
    at("  // ---- Queries: rows i of tile t against the key tiles j <= i.\n",
       before="  " + stamp(Q_BF16))
    at("    __syncthreads();         // this key tile in; the last one's "
       "reads done\n", after="    " + stamp(f"{QS_BF16} + qs_", QUERY)
       + "    ++qs_;\n")
    at("  // The entering state's terms: u_i = h_in^T dy_i, inter_i = "
       "e^{cum_i}\n", before="  " + stamp(ENTER_BF16))


def stamped_source(src: str, dtype: str = "f32") -> str:
    """``src`` with thread 0's stamps inserted in the dtype's chunk-local
    kernel at fixed anchors."""
    if dtype == "f32":
        return _splice(src, "ssd_bwd_local_kernel(const float* __restrict__ "
                            "xdt,", f32_edits)
    return _splice(src, "ssd_bwd_local_mma_kernel(const bf16* __restrict__ "
                        "xdt,", bf16_edits)


def f32_cycles(rs, t, nt):
    """The f32 kernel's phases for the blocks ``rs`` of tile t."""
    def mean(fn):
        return round(statistics.mean(fn(r) for r in rs), 1)

    pairs, steps = min(nt - t, PAIRS), min(t + 1, PAIRS)
    key = []
    for k in range(pairs):
        i = KEY0 + 4 * k
        prev = (lambda r, i=i: r[i - 1]) if k else (lambda r: 0)
        key.append({
            "wait": mean(lambda r, i=i, prev=prev: r[i] - prev(r)),
            "tile_dot": mean(lambda r, i=i: r[i + 1] - r[i]),
            "decays": mean(lambda r, i=i: r[i + 2] - r[i + 1]),
            "rows_times": mean(lambda r, i=i: r[i + 3] - r[i + 2])})
    last_key = KEY0 + 4 * (pairs - 1) + 3
    query = []
    for q in range(steps):
        i = QUERY0 + 4 * q
        prev = (lambda r, i=i: r[i - 1]) if q else (lambda r: r[KEYS_END])
        query.append({
            "wait": mean(lambda r, i=i, prev=prev: r[i] - prev(r)),
            "tile_dot": mean(lambda r, i=i: r[i + 1] - r[i]),
            "decays": mean(lambda r, i=i: r[i + 2] - r[i + 1]),
            "rows_times": mean(lambda r, i=i: r[i + 3] - r[i + 2])})
    last_query = QUERY0 + 4 * (steps - 1) + 3
    return {
        "blocks": len(rs), "key_pairs": key,
        "key_tail_and_state": mean(lambda r: r[STATE] - r[last_key]),
        "state_terms_and_writes": mean(lambda r: r[KEYS_END] - r[STATE]),
        "query_steps": query,
        "entering_state": mean(lambda r: r[ENTER] - r[last_query]),
        "query_writes": mean(lambda r: r[END] - r[ENTER]),
        "block": mean(lambda r: r[END])}


def bf16_cycles(rs, t, nt):
    """The bf16 kernel's phases for the blocks ``rs`` of tile t: each
    span from one stamp to the next."""
    def mean(fn):
        return round(statistics.mean(fn(r) for r in rs), 1)

    def spans(first, count, end):
        marks = [first + k for k in range(count)] + [end]
        return [mean(lambda r, a=a, b=b: r[b] - r[a])
                for a, b in zip(marks, marks[1:])]

    pairs, steps = min(nt - t, PAIRS), min(t + 1, PAIRS)
    return {
        "blocks": len(rs),
        "start_to_first_pair": mean(lambda r: r[P1]),
        "pass1_pairs": spans(P1, pairs, P1_END),
        "dx_state_and_writes": mean(lambda r: r[T_TERM] - r[P1_END]),
        "db_state_term": mean(lambda r: r[T_END] - r[T_TERM]),
        "restage": mean(lambda r: r[P2] - r[T_END]),
        "pass2_pairs": spans(P2, pairs, DB_WRITES),
        "db_writes": mean(lambda r: r[Q_BF16] - r[DB_WRITES]),
        "query_start": mean(lambda r: r[QS_BF16] - r[Q_BF16]),
        "query_steps": spans(QS_BF16, steps, ENTER_BF16),
        "entering_state_and_writes": mean(lambda r: r[END] - r[ENTER_BF16]),
        "block": mean(lambda r: r[END])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("k5_bwd_timeline: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import BUILD_DIR, build_library
    from repro_torch.kernels.mamba_scan import mamba_scan as k5

    (src_path,) = k5.SOURCES
    with open(src_path) as f:
        text = stamped_source(f.read(), args.dtype)
    os.makedirs(BUILD_DIR, exist_ok=True)
    name = f"k5_bwd_timeline_{args.dtype}"
    copy = os.path.join(BUILD_DIR, f"{name}.cu")
    with open(copy, "w") as f:
        f.write(text)
    lib = ctypes.CDLL(build_library(name, [copy], k5.HEADERS))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [vp] * 11 + [i32] * 7 + [vp]
    lib.ssd_scan_bwd.restype = i32
    lib.ssd_scan_bwd_workspace_floats.argtypes = [i32] * 4
    lib.ssd_scan_bwd_workspace_floats.restype = ctypes.c_longlong

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 19)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev)

    h, g, s, p, n, chunk = cs.K5_BWD_SHAPE
    dt = torch.float32 if args.dtype == "f32" else torch.bfloat16
    dtv = rand((h, s)).abs() * 0.1 + 0.01
    la = dtv * -(rand((h,)).abs() + 0.1)[:, None]
    xdt = (rand((h, s, p)) * dtv[..., None]).to(dt)
    bg, cg = rand((g, s, n)).to(dt), rand((g, s, n)).to(dt)
    dy = rand((h, s, p)).to(dt)
    nc, nt = -(-s // chunk), -(-chunk // 64)
    blocks = h * nc * nt
    if blocks > 2048:
        raise RuntimeError(f"{blocks} blocks: the stamps hold 2048")

    def stamped():
        work = torch.empty(lib.ssd_scan_bwd_workspace_floats(h, s, n, chunk),
                           device=dev)
        out = (torch.empty_like(xdt), torch.empty_like(la),
               torch.empty_like(bg), torch.empty_like(cg))
        err = lib.ssd_scan_bwd(
            xdt.data_ptr(), la.data_ptr(), bg.data_ptr(), cg.data_ptr(),
            dy.data_ptr(), None, *(t.data_ptr() for t in out),
            work.data_ptr(), h, s, p, n, chunk, h // g,
            0 if args.dtype == "f32" else 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"stamped backward failed: CUDA error {err}")
        return out

    def port():
        return k5.ssd_scan_bwd(xdt, la, bg, cg, dy, None, chunk=chunk,
                               rep=h // g)

    want = port()
    got = stamped()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (STAMPS * blocks))()
    if lib.k5_read_stamps(buf, blocks):
        raise RuntimeError("could not read the stamps")
    rows = [buf[i * STAMPS:(i + 1) * STAMPS] for i in range(blocks)]
    by_tile = collections.defaultdict(list)
    for i, r in enumerate(rows):
        by_tile[i // (h * nc)].append(r)
    cycles = f32_cycles if args.dtype == "f32" else bf16_cycles
    tiles = {t: cycles(rs, t, nt) for t, rs in sorted(by_tile.items())}
    sms = collections.defaultdict(list)
    for r in rows:
        sms[r[SMID]].append((r[START], r[START] + r[END]))
    spans = {sm: (len(v), sum(e - b for b, e in v),
                  max(e for _, e in v) - min(b for b, _ in v))
             for sm, v in sms.items()}
    out = {
        "card": cs.card_line(),
        "dtype": args.dtype,
        "shape": {"xdt": [h, s, p], "bc": [g, s, n], "chunk": chunk},
        "bitwise_equal_to_the_port": all(
            torch.equal(a, b) for a, b in zip(got, want, strict=True)),
        "device_ms_by_kernel": cs.device_ms_by_kernel(torch, port),
        "stamped_device_ms": cs.device_ms(torch, stamped),
        "cycles_by_tile": tiles,
        "sms": len(spans),
        "blocks_per_sm": [min(v[0] for v in spans.values()),
                          max(v[0] for v in spans.values())],
        "sm_busy_cycles": [min(v[1] for v in spans.values()),
                           max(v[1] for v in spans.values())],
        "sm_span_cycles": [min(v[2] for v in spans.values()),
                           max(v[2] for v in spans.values())]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
