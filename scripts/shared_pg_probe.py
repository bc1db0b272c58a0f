#!/usr/bin/env python3
"""Collectives over the ``"shared"`` backend alone, ranks sharing one card.

    python3 scripts/shared_pg_probe.py [--src DIR] [--worlds 2 4 8]

Run from the repository root on the machine with the card.  Imports
``repro_torch`` from ``DIR`` (default: this checkout's ``src``; give the
``src`` of another tree, unpacked under ``_checkout/``, to time its
transport) and starts, for each world size, that many processes on card 0
over ``launch/shared_pg.py``'s backend.  Each rank times, host clock
around work that ends in ``torch.cuda.synchronize()``:

  - ``small_ms``: a 16 KiB f32 all-reduce, mean of 300;
  - ``mid_4MiB_ms``: a 4 MiB f32 all-reduce, mean of 50;
  - ``mm_ms`` / ``mm_allreduce_ms``: a (2048, 4096) @ (4096, 4096) bf16
    product alone, and followed by an all-reduce of its output, mean of 50;
  - ``allgather_s``: an all-gather of 128 Mi f32 (0.54 GB) a rank over the
    world, best of 3, and ``pair_allgather_s`` over pairs of ranks (ranks
    0-1, 2-3, ...), each output checked against the ranks' seeded inputs.

It prints the card's name and power limit, then one JSON line a world
size: rank 0's figures.  To compare two trees, run them in turns (A, B,
B, A) in one call.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(src: str, rank: int, world: int, port: int) -> None:
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch.launch import shared_pg

    torch.cuda.set_device(0)
    shared_pg.register()
    dist.init_process_group("shared", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    pairs = [dist.new_group([i, i + 1]) for i in range(0, world - 1, 2)]

    def timed(fn, iters: int) -> float:
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters

    out = {}
    s = torch.randn(4096, device="cuda")
    out["small_ms"] = timed(lambda: dist.all_reduce(s), 300) * 1e3
    m = torch.randn(1 << 20, device="cuda")
    out["mid_4MiB_ms"] = timed(lambda: dist.all_reduce(m), 50) * 1e3
    x = torch.randn(2048, 4096, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    out["mm_ms"] = timed(lambda: x @ w, 50) * 1e3
    out["mm_allreduce_ms"] = timed(lambda: dist.all_reduce(x @ w), 50) * 1e3
    del x, w

    n = 128 * 2**20

    def seeded(r):
        gen = torch.Generator(device="cuda").manual_seed(r)
        return torch.randn(n, generator=gen, device="cuda")

    big = seeded(rank)
    for key, group, first in (("allgather_s", None, 0),
                              ("pair_allgather_s", pairs[rank // 2],
                               rank // 2 * 2)):
        size = dist.get_world_size(group)
        y = torch.empty(size * n, device="cuda")
        out[key] = min(timed(lambda: dist.all_gather_into_tensor(
            y, big, group=group), 1) for _ in range(3))
        out[key + "_ok"] = all(torch.equal(y[i * n:(i + 1) * n],
                                           seeded(first + i))
                               for i in range(size))
        del y
    out["mailbox_bytes"] = shared_pg.stats()["mailbox_peak_bytes"]["cuda"]
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--worlds", type=int, nargs="+", default=[2, 4, 8])
    args = ap.parse_args()
    if any(w < 2 or w % 2 for w in args.worlds):
        ap.error("world sizes are even (pairs of ranks)")
    src = os.path.abspath(args.src)
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, "
                    f"{src!r}); from repro_torch.launch import shared_pg; "
                    "shared_pg.load_library()"], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for world in args.worlds:
        with socket.socket() as so:
            so.bind(("127.0.0.1", 0))
            port = so.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", src,
             str(r), str(world), str(port)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            print(f"world {world} failed: {outs[0][1][-2000:]}", flush=True)
            return 1
        print(json.dumps({"world": world, "src": src,
                          **json.loads(outs[0][0].strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2], *map(int, sys.argv[3:6]))
        sys.exit(0)
    sys.exit(main())
