#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

  1. device  — the card's name and power limit (``nvidia-smi``),
  2. build   — the prefill kernel library from ``src/repro_torch/kernels/
               prefill/csrc`` (nvcc, sm_90a), with its build seconds,
  3. kernels — K1 (``prefill_flash``) and K2 (``cache_cast``) held against
               their plain torch versions on the card: K1 through
               ``prefill_attention``, the op the model calls, at every
               bucket the serve phase pads to (and 48, 768, head_dim 16);
               then both timed at the serve path's shapes beside the plain
               version, PyTorch's own call for the same function, and the
               card's bound,
  4. model   — full-width Qwen2-1.5B in f32 from ``Model.init(seed)``:
               prefill logits on the kernel path against ``use_pallas=False``
               for one prompt of length 100 (bucket 128), greedy first tokens
               equal; the cache is stored in bf16, so K2 runs on this path,
  5. serve   — full-width bf16 Qwen2-1.5B serving 8 seeded requests through
               ``Cluster("fast=2.0^prefill,slow=1.0x4^decode").serve``: every
               request completes with 16 tokens, 8 KV handoffs, and K1 runs
               once per layer per prefill (8 x 28 launches); the wall time
               is split into the engines' prefill, insert and step calls
               and the control plane around them.  The inputs K1 got on
               this path, one set per bucket, are kept and K1 is held
               against its plain version on them afterwards.

Phases 4 and 5 are the main path: the kernels' launch counts are set to 0
just before each and read just after it; the ``kernels`` line gives each
kernel's launches in all and by phase.  The next-to-last line is the
``kernels`` JSON object; a line before it holds the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the repository's ``src/repro_torch`` beside this file, it exits with
code 2 and prints no result.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

TOL = {"bfloat16": (2e-2, 2e-2), "float32": (5e-4, 5e-5)}   # (rtol, atol)
SEED = 0
N_LAYERS = 28


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, reps: int = 7,
            warmup: int = 5) -> float:
    """Milliseconds per call on the card: the median over ``reps`` loops of
    ``iters`` calls, each loop timed by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return sorted(per_call)[reps // 2]


def check_close(torch, name, got, want, dtype_name) -> float:
    rtol, atol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite values")
    bad = err > atol + rtol * w.abs()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements outside rtol {rtol} / "
             f"atol {atol}, max abs err {float(err.max()):.3e}")
    return float(err.max())


@contextlib.contextmanager
def keep_inputs(module, name):
    """Wrap ``module.<name>(q, k, v, ...)`` while the block runs and keep a
    copy of the first q, k, v it gets for each shape and dtype."""
    kept = {}
    saved = getattr(module, name)

    @functools.wraps(saved)
    def call(q, k, v, *args, **kwargs):
        key = (tuple(q.shape), tuple(k.shape), q.dtype)
        if key not in kept:
            kept[key] = (q.clone(), k.clone(), v.clone(), kwargs.get("group"))
        return saved(q, k, v, *args, **kwargs)

    setattr(module, name, call)
    try:
        yield kept
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def wall_split(cls, names):
    """Calls and host seconds spent in each method ``cls.<name>`` while the
    block runs.  ``DecodeEngine.prefill`` and ``.step`` end by copying logits
    to the host, which waits for the device, so the host clock around them
    covers their device work; ``insert`` only enqueues its cache copy."""
    spent = {n: [0, 0.0] for n in names}
    saved = {n: getattr(cls, n) for n in names}

    def timed(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name][0] += 1
                spent[name][1] += time.perf_counter() - t
        return call

    for n in names:
        setattr(cls, n, timed(n, saved[n]))
    try:
        yield spent
    finally:
        for n in names:
            setattr(cls, n, saved[n])


def flash_bound_ms(bh: int, s: int, d: int, hkv_rows: int, itemsize: int,
                   dtype_name: str) -> tuple[float, str]:
    """Least time for causal prefill attention: q, k, v read once, out
    written once; 4*D operations per (query, visible key) pair."""
    nbytes = itemsize * d * s * (2 * bh + 2 * hkv_rows)
    ops = 4 * d * bh * s * (s + 1) // 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_attention(torch, q, k, v):
    """PyTorch's own causal GQA attention on the same inputs, as a
    yardstick for K1 only (the port never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = q[None], k[None], v[None]
    return lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from repro_torch.cluster import Cluster, ServeJob
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.kernels.prefill import ops
    from repro_torch.kernels.prefill import prefill as pf
    from repro_torch.kernels.prefill.ref import cache_cast_ref, prefill_ref
    from repro_torch.models import Model
    from repro_torch.serve import DecodeEngine, Request

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ------------------------------------------------------------ 1. device
    card = card_line()
    print(f"[device] {card}  (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    pf.load_library()
    build_s = time.perf_counter() - t0
    print(f"[build] prefill kernels built and loaded in {build_s:.2f} s",
          flush=True)
    log = os.path.join(BUILD_DIR, "prefill.log")
    if os.path.exists(log):          # absent when the library was cached
        with open(log) as f:
            text = f.read()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", text)]
        print(f"[build] ptxas: {len(regs)} kernels, registers per thread "
              f"{min(regs)}..{max(regs)}, spill stores up to {max(spills)} "
              "bytes", flush=True)

    # ----------------------------------------------------------- 3. kernels
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    # K1 through the op the model calls, at the serve phase's buckets (16 ..
    # 512), the clamped 48, a 768 past the largest, and head_dim 16; each
    # against use_pallas=False on the same inputs.
    k1_err = 0.0
    cases = [(16, 2, 128, s, dt)
             for s in (16, 32, 48, 64, 128, 256, 512, 768)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(4, 2, 16, s, dt)
              for s in (16, 48, 128) for dt in (torch.bfloat16, torch.float32)]
    for hq, hkv, d, s, dt in cases:
        q = rand((1, s, hq, d), dt)
        k, v = rand((1, s, hkv, d), dt), rand((1, s, hkv, d), dt)
        before = pf.LAUNCHES["prefill_flash"]
        out, kc, vc = ops.prefill_attention(q, k, v)
        torch.cuda.synchronize()
        ref, kr, vr = ops.prefill_attention(q, k, v, use_pallas=False)
        name = f"K1 Hq={hq} Hkv={hkv} D={d} S={s} {str(dt)[6:]}"
        if pf.LAUNCHES["prefill_flash"] != before + 1:
            fail(f"{name}: prefill_attention did not launch K1")
        err = check_close(torch, name, out, ref, str(dt)[6:])
        if not (torch.equal(kc, kr) and torch.equal(vc, vr)):
            fail(f"{name}: same-dtype cache differs from the inputs")
        k1_err = max(k1_err, err)
        print(f"[kernels] {name}: max abs err {err:.3e}", flush=True)

    # K2 at the model phase's shape: (B*Hkv, bucket, D) f32 -> bf16.
    k32, v32 = rand((2, 128, 128), torch.float32), rand((2, 128, 128), torch.float32)
    kc, vc = pf.cache_cast(k32, v32, torch.bfloat16)
    torch.cuda.synchronize()
    kr, vr = cache_cast_ref(k32, v32, torch.bfloat16)
    if not (torch.equal(kc, kr) and torch.equal(vc, vr)):
        fail("K2 f32->bf16 cast is not bitwise equal to .to(bfloat16)")
    k2_err = max(float((kc.float() - kr.float()).abs().max()),
                 float((vc.float() - vr.float()).abs().max()))
    print("[kernels] K2 (2, 128, 128) f32->bf16: bitwise equal to .to()",
          flush=True)

    # Timings at the serve path's shapes: Hq=16, Hkv=2, D=128, bf16.
    sweep = []
    for s in (16, 32, 64, 128, 256, 512):
        q = rand((16, s, 128), torch.bfloat16)
        k, v = rand((2, s, 128), torch.bfloat16), rand((2, s, 128), torch.bfloat16)
        row = {
            "S": s,
            "ms": time_ms(torch, lambda: pf.prefill_flash(q, k, v, group=8)),
            "plain_ms": time_ms(torch, lambda: prefill_ref(q, k, v, group=8)),
            "library_ms": time_ms(torch, library_attention(torch, q, k, v)),
        }
        row["bound_ms"], row["bound_by"] = flash_bound_ms(16, s, 128, 2, 2,
                                                          "bfloat16")
        sweep.append(row)
        print(f"[kernels] K1 bf16 Hq=16 Hkv=2 D=128 S={s}: "
              + json.dumps(row), flush=True)
    k1_row = sweep[-1]
    k2_bytes = 2 * k32.numel() * (4 + 2)
    k2 = {
        "ms": time_ms(torch, lambda: pf.cache_cast(k32, v32, torch.bfloat16)),
        "plain_ms": time_ms(torch, lambda: cache_cast_ref(k32, v32,
                                                          torch.bfloat16)),
        "library_ms": time_ms(torch, lambda: (k32.to(torch.bfloat16),
                                              v32.to(torch.bfloat16))),
        "bound_ms": 1e3 * k2_bytes / HBM_BYTES_PER_S,
    }
    print(f"[kernels] K2 f32->bf16 (2, 128, 128) x2: {json.dumps(k2)}",
          flush=True)

    # ------------------------------------------------ 4. model (main path)
    for key in pf.LAUNCHES:
        pf.LAUNCHES[key] = 0
    cfg32 = get_config("qwen2-1.5b", param_dtype="float32",
                       compute_dtype="float32", cache_dtype="bfloat16")
    model = Model(cfg32)
    plain = Model(dataclasses.replace(cfg32, use_pallas=False))
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    print(f"[model] {cfg32.name} f32 init on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(SEED)
    L, bucket = 100, 128
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :L] = rng.integers(0, cfg32.vocab_size, L)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    with torch.no_grad():
        lk, ck = model.prefill(params, batch, last_pos=L - 1)
        lp, cp = plain.prefill(params, batch, last_pos=L - 1)
    torch.cuda.synchronize()
    if tuple(lk.shape) != (1, 1, cfg32.padded_vocab):
        fail(f"model: logits shape {tuple(lk.shape)}")
    model_err = check_close(torch, "model prefill logits (kernel vs plain)",
                            lk, lp, "float32")
    kcache = ck["periods"]["pos0"]["self"].k
    if kcache.dtype != torch.bfloat16 or \
            cp["periods"]["pos0"]["self"].k.dtype != torch.float32:
        fail("model: the kernel branch must return the cache in the cache "
             "dtype and the plain branch uncast")
    tok_k = int(lk[0, 0, :cfg32.vocab_size].argmax())
    tok_p = int(lp[0, 0, :cfg32.vocab_size].argmax())
    if tok_k != tok_p:
        fail(f"model: greedy first tokens differ ({tok_k} vs {tok_p})")
    print(f"[model] prefill L={L} (bucket {bucket}): logits max abs err "
          f"{model_err:.3e}, greedy first token {tok_k} on both paths",
          flush=True)
    model_launches = dict(pf.LAUNCHES)
    del params, lk, lp, ck, cp, kcache
    torch.cuda.empty_cache()

    # ------------------------------------------------ 5. serve (main path)
    cfg = get_config("qwen2-1.5b")
    model = Model(cfg)
    params = model.init(SEED)
    lengths = (5, 20, 40, 90, 150, 300, 420, 500)    # buckets 16 .. 512
    requests = [
        Request(rid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab_size, n)],
                max_new_tokens=16)
        for i, n in enumerate(lengths)
    ]
    cluster = Cluster("fast=2.0^prefill,slow=1.0x4^decode")
    torch.cuda.synchronize()
    for key in pf.LAUNCHES:
        pf.LAUNCHES[key] = 0
    with wall_split(DecodeEngine, ("prefill", "insert", "step")) as spent, \
            keep_inputs(ops, "_prefill_call") as seen:
        t0 = time.perf_counter()
        rep = cluster.serve(ServeJob(requests, model=model, params=params,
                                     max_seq=1024))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    serve_launches = dict(pf.LAUNCHES)
    k1_serve = serve_launches["prefill_flash"]
    m = rep.metrics
    for r in requests:
        if not r.done or len(r.out_tokens) != 16:
            fail(f"serve: request {r.rid} done={r.done} with "
                 f"{len(r.out_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            fail(f"serve: request {r.rid} emitted a token outside the vocab")
    if m.get("mode") != "disaggregated" or m["n_handoffs"] != len(requests):
        fail(f"serve: mode {m.get('mode')}, {m.get('n_handoffs')} handoffs")
    if k1_serve != len(requests) * N_LAYERS:
        fail(f"serve: K1 launched {k1_serve} times, expected "
             f"{len(requests) * N_LAYERS}")
    n_tok = sum(len(r.out_tokens) for r in requests)
    split = {k: v["mean"] for k, v in m["ttft_split"].items() if k != "n"}
    print(f"[serve] {card}: {len(requests)} requests, {n_tok} tokens in "
          f"{wall_s:.3f} s wall -> {n_tok / wall_s:.2f} tokens/s; "
          f"{m['n_handoffs']} handoffs; K1 launches {k1_serve}; "
          f"TTFT split (sim-clock s, mean) {json.dumps(split)}", flush=True)
    engine_s = sum(sec for _, sec in spent.values())
    print("[serve] host wall split: " + ", ".join(
        f"{name} {n} calls {sec:.3f} s" for name, (n, sec) in spent.items())
        + f", the rest (control plane) {wall_s - engine_s:.3f} s", flush=True)

    # K1 against its plain version on the inputs the serve path gave it.
    buckets = sorted(key[0][1] for key in seen)
    if buckets != [16, 32, 64, 128, 256, 512]:
        fail(f"serve: K1 saw buckets {buckets}, expected 16 .. 512")
    for (qs, _, dt), (q, k, v, group) in sorted(seen.items(),
                                                key=lambda kv: kv[0][0]):
        name = f"K1 on serve inputs q {qs} {str(dt)[6:]}"
        out, _, _ = pf.prefill_flash(q, k, v, group=group)
        torch.cuda.synchronize()
        ref, _, _ = prefill_ref(q, k, v, group=group)
        err = check_close(torch, name, out, ref, str(dt)[6:])
        k1_err = max(k1_err, err)
        print(f"[serve] {name}: max abs err {err:.3e}", flush=True)

    by_path = {key: {"model": model_launches[key],
                     "serve": serve_launches[key]} for key in pf.LAUNCHES}
    launches = {key: sum(n.values()) for key, n in by_path.items()}
    for key, n in launches.items():
        if n == 0:
            fail(f"kernel {key} was not launched on the main path")
    print(f"[main path] launches by phase: {json.dumps(by_path)}", flush=True)

    src = "src/repro_torch/kernels/prefill/csrc/prefill.cu"
    kernels = {"kernels": [
        {"name": "prefill_flash", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/prefill/prefill.py:119",
         "launches": launches["prefill_flash"],
         "launches_by_path": by_path["prefill_flash"], "max_abs_err": k1_err,
         "ms": k1_row["ms"], "plain_ms": k1_row["plain_ms"],
         "bound_ms": k1_row["bound_ms"], "bound_by": k1_row["bound_by"],
         "library_ms": k1_row["library_ms"]},
        {"name": "cache_cast", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/prefill/prefill.py:145",
         "launches": launches["cache_cast"],
         "launches_by_path": by_path["cache_cast"], "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": k2["library_ms"]},
    ]}
    print(f"[card] {card}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
