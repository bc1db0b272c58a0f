"""The ``"shared"`` process-group backend (``launch/shared_pg.py``) on its
CPU route: host mailboxes in ``/dev/shm``, the same protocol, chunking and
rank order as the device route, with the plain versions.

Two and three ranks run in subprocesses with a slot of 256 bytes, so every
tensor here passes through several chunks.  Each rank makes every rank's
inputs from the same numpy seeds.  All-gather (into a tensor and into a
list), all-to-all (uneven and empty splits) and broadcast must be bitwise
``gloo``'s on the same inputs; all-reduce and reduce-scatter (sum and max)
bitwise the rank-ordered plain reduction (f32 accumulation, one rounding)
and the same on every rank; in f32, bf16, f16 and int64, through the
methods ``torch.distributed`` calls, their coalesced forms, the functional
collectives ``sharding/tp.py`` calls, non-contiguous inputs and a
subgroup.  An unsupported op or dtype and a call that mixes devices raise;
``destroy_process_group`` frees every mailbox; a rank that exits with an
exception does not hang its peer.  The kernels themselves are held against
these plain versions on the card (``tests/test_torch_cuda.py``).
"""

import json
import math
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLOT = 256
DTYPES = ("float32", "bfloat16", "float16", "int64")

_WORKER = textwrap.dedent(
    """
    import hashlib, json, math, sys, warnings
    warnings.filterwarnings("ignore")
    import numpy as np
    import torch, torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch import shared_pg
    torch.set_num_threads(1)
    rank, world, port, slot = map(int, sys.argv[1:5])
    shared_pg.register(slot_bytes=slot)
    dist.init_process_group("shared", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    gloo = dist.new_group(backend="gloo")
    pg = dist.group.WORLD
    out = {}

    def data(r, shape, dt, seed):
        rng = np.random.default_rng(1000 * seed + r)
        if dt == torch.int64:
            return torch.from_numpy(rng.integers(-1000, 1000, size=shape))
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt)

    def bits(t):
        t = t.contiguous()
        return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])

    def same(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and \\
            torch.equal(bits(a), bits(b))

    def digest(t):
        return hashlib.sha256(bits(t).numpy().tobytes()).hexdigest()

    def plain(ts, op):
        return shared_pg.reduce_plain(ts, op)

    def raw(t):
        # the bytes gloo moves for the comparison: data movement only
        return t.contiguous().view(torch.uint8)

    OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    for seed, name in enumerate(["float32", "bfloat16", "float16", "int64"]):
        dt = getattr(torch, name)
        shape = (7, 29)                       # several slots, ragged tail
        xs = [data(r, shape, dt, seed) for r in range(world)]
        for op in ("sum", "max"):
            y = xs[rank].clone()
            dist.all_reduce(y, op=OPS[op])
            want = plain(xs, op)
            out[f"all_reduce-{op}-{name}"] = {"ok": same(y, want),
                                              "digest": digest(y)}
            big = [data(r, (world * 11, 13), dt, seed + 10)
                   for r in range(world)]
            y = torch.empty(11, 13, dtype=dt)
            dist.reduce_scatter_tensor(y, big[rank], op=OPS[op])
            want = plain(big, op)[rank * 11:(rank + 1) * 11]
            out[f"reduce_scatter-{op}-{name}"] = {"ok": same(y, want),
                                                  "digest": digest(y)}
        # all-gather into a tensor, against gloo's
        y = torch.empty(world * 7, 29, dtype=dt)
        dist.all_gather_into_tensor(y, xs[rank])
        g = torch.empty_like(raw(y))
        dist.all_gather_into_tensor(g, raw(xs[rank]), group=gloo)
        out[f"all_gather-{name}"] = {"ok": torch.equal(raw(y), g) and
                                     same(y, torch.cat(xs)),
                                     "digest": digest(y)}
        # the list form
        ys = [torch.empty(shape, dtype=dt) for _ in range(world)]
        dist.all_gather(ys, xs[rank])
        gs = [torch.empty_like(raw(xs[0])) for _ in range(world)]
        dist.all_gather(gs, raw(xs[rank]), group=gloo)
        out[f"all_gather_list-{name}"] = {"ok": all(
            torch.equal(raw(a), b) for a, b in zip(ys, gs)),
            "digest": digest(torch.cat(ys))}
        # broadcast from the last rank
        y = xs[rank].clone()
        dist.broadcast(y, src=world - 1)
        g = raw(xs[rank]).clone()
        dist.broadcast(g, src=world - 1, group=gloo)
        out[f"broadcast-{name}"] = {"ok": torch.equal(raw(y), g) and
                                    same(y, xs[-1]), "digest": digest(y)}
        # all-to-all: rows[r][j] rows of 5 from r to j, some empty, some
        # smaller than a chunk, some several chunks
        rows = [[(r * 3 + j * 5) % 4 * 9 for j in range(world)]
                for r in range(world)]
        send = data(rank, (sum(rows[rank]), 5), dt, seed + 20)
        recv = [rows[j][rank] for j in range(world)]
        y = torch.empty(sum(recv), 5, dtype=dt)
        dist.all_to_all_single(y, send, recv, rows[rank])
        g = torch.empty_like(raw(y))
        dist.all_to_all_single(g, raw(send), recv, rows[rank], group=gloo)
        out[f"all_to_all-{name}"] = {"ok": torch.equal(raw(y), g),
                                     "digest": digest(y),
                                     "empty": any(0 in r for r in rows)}

    # coalesced forms, called on the group as DTensor's ops call them
    f32 = [data(r, (5, 17), torch.float32, 30) for r in range(world)]
    bf = [data(r, (3, 40), torch.bfloat16, 31) for r in range(world)]
    ys = [f32[rank].clone(), bf[rank].clone()]
    pg.allreduce_coalesced(ys, dist.AllreduceCoalescedOptions()).wait()
    ok = same(ys[0], plain(f32, "sum")) and same(ys[1], plain(bf, "sum"))
    outs = [torch.empty(world * 5, 17), torch.empty(world * 3, 40,
                                                    dtype=torch.bfloat16)]
    pg.allgather_into_tensor_coalesced(outs, [f32[rank], bf[rank]]).wait()
    ok = ok and same(outs[0], torch.cat(f32)) and same(outs[1], torch.cat(bf))
    rs = [torch.empty(5, 17), torch.empty(3, 40, dtype=torch.bfloat16)]
    big = [[data(r, (world * 5, 17), torch.float32, 32),
            data(r, (world * 3, 40), torch.bfloat16, 33)]
           for r in range(world)]
    opts = dist.ReduceScatterOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    pg.reduce_scatter_tensor_coalesced(rs, big[rank], opts).wait()
    for i, m in enumerate((5, 3)):
        want = plain([b[i] for b in big], "sum")[rank * m:(rank + 1) * m]
        ok = ok and same(rs[i], want)
    out["coalesced"] = {"ok": ok, "digest": digest(ys[0])}

    # the functional collectives sharding/tp.py runs
    x = data(rank, (4, 6, 10), torch.float32, 40)
    xs = [data(r, (4, 6, 10), torch.float32, 40) for r in range(world)]
    a = funcol.wait_tensor(funcol.all_reduce(x, "sum", pg))
    b = funcol.wait_tensor(funcol.all_reduce(x, "max", pg))
    c = funcol.wait_tensor(funcol.all_gather_tensor(x, 1, pg))
    xw = data(rank, (4, 6 * world, 10), torch.float32, 41)
    xws = [data(r, (4, 6 * world, 10), torch.float32, 41)
           for r in range(world)]
    d = funcol.wait_tensor(funcol.reduce_scatter_tensor(xw, "sum", 1, pg))
    out["funcol"] = {"ok": same(a, plain(xs, "sum")) and
                     same(b, plain(xs, "max")) and
                     same(c, torch.cat(xs, 1)) and
                     same(d, plain(xws, "sum")[:, rank * 6:(rank + 1) * 6]),
                     "digest": digest(a)}

    # non-contiguous inputs and outputs, written back into the caller's
    base = data(rank, (29, 7), torch.float32, 50)
    bases = [data(r, (29, 7), torch.float32, 50) for r in range(world)]
    y = base.clone().t()
    dist.all_reduce(y)
    ok = same(y, plain([b.t() for b in bases], "sum"))
    ys = [torch.empty(29, 7).t() for _ in range(world)]
    dist.all_gather(ys, base.t())
    ok = ok and all(same(a, b.t()) for a, b in zip(ys, bases))
    y = base.clone().t()
    dist.broadcast(y, src=0)
    ok = ok and same(y, bases[0].t())
    out["non_contiguous"] = {"ok": ok and not y.is_contiguous(),
                             "digest": digest(y)}

    # zero elements and a barrier
    e = torch.empty(0)
    dist.all_reduce(e)
    ez = torch.empty(0)
    dist.all_gather_into_tensor(ez, torch.empty(0))
    dist.barrier()
    out["empty"] = {"ok": e.numel() == 0, "digest": ""}

    # a subgroup of ranks 0 and 1: its own store prefix and mailboxes
    sub = dist.new_group([0, 1])
    if rank < 2:
        y = xs[rank].clone()
        dist.all_reduce(y, group=sub)
        out["subgroup"] = {"ok": same(y, plain(xs[:2], "sum")),
                           "digest": digest(y)}
    else:
        out["subgroup"] = {"ok": True, "digest": None}

    # what the backend refuses
    def raises(fn, kind, text):
        try:
            fn()
        except kind as e:
            return text in str(e)
        return False

    out["refuses"] = {
        "product": raises(lambda: dist.all_reduce(
            torch.ones(3), op=dist.ReduceOp.PRODUCT), ValueError,
            "SUM and MAX"),
        "float64": raises(lambda: dist.all_reduce(
            torch.ones(3, dtype=torch.float64)), TypeError, "float64"),
        "mixed": raises(lambda: dist.all_gather_into_tensor(
            torch.empty(world * 3, device="meta"), torch.ones(3)),
            ValueError, "one device")}
    before = dict(shared_pg.MEMORY)
    out["counters"] = shared_pg.stats()["ops"]
    dist.destroy_process_group()
    out["memory"] = {"before": before, "after": dict(shared_pg.MEMORY)}
    print(json.dumps(out))
    """
)

_CRASH = textwrap.dedent(
    """
    import datetime, sys, time, warnings
    warnings.filterwarnings("ignore")
    import torch, torch.distributed as dist
    from repro_torch.launch import shared_pg
    rank, world, port, slot = map(int, sys.argv[1:5])
    shared_pg.register(slot_bytes=slot)
    dist.init_process_group("shared", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    y = torch.ones(1000)
    dist.all_reduce(y)                    # mailboxes made, one collective
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    t0 = time.perf_counter()
    try:
        dist.all_reduce(y)
    except Exception as e:
        print(f"raised after {time.perf_counter() - t0:.1f} s: "
              f"{type(e).__name__}")
        sys.exit(3)
    print("returned")
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(worker: str, world: int, timeout: int = 120):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(r), str(world), str(port),
         str(SLOT)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


_RESULTS: dict[int, list[dict]] = {}


def _ranks(world: int) -> list[dict]:
    """Every rank's results at ``world`` ranks (run once a module)."""
    if world not in _RESULTS:
        rcs, outs = _launch(_WORKER, world)
        for rc, (_, err) in zip(rcs, outs, strict=True):
            assert rc == 0, err[-3000:]
        _RESULTS[world] = [json.loads(o.strip().splitlines()[-1])
                           for o, _ in outs]
    return _RESULTS[world]


_CASES = ([f"{c}-{op}-{dt}" for c in ("all_reduce", "reduce_scatter")
           for op in ("sum", "max") for dt in DTYPES]
          + [f"{c}-{dt}" for c in ("all_gather", "all_gather_list",
                                   "broadcast", "all_to_all")
             for dt in DTYPES]
          + ["coalesced", "funcol", "non_contiguous", "empty", "subgroup"])


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", _CASES)
def test_collective_matches_gloo_and_the_plain_reduction(world, case):
    """Each collective bitwise its reference on every rank (gloo's for
    data movement, the rank-ordered plain reduction for sums and maxima),
    and every rank's result the same where the collective replicates it."""
    ranks = _ranks(world)
    for r, res in enumerate(ranks):
        assert res[case]["ok"], (case, r)
    if case.startswith(("all_reduce", "all_gather", "broadcast", "coalesced",
                        "funcol")):
        assert len({res[case]["digest"] for res in ranks}) == 1, case
    if case == "subgroup":
        assert ranks[0][case]["digest"] == ranks[1][case]["digest"]
    if case.startswith("all_to_all"):
        assert ranks[0][case]["empty"]


@pytest.mark.parametrize("world", [2, 3])
def test_tensors_pass_in_chunks_of_a_slot(world):
    """A 7 x 29 tensor passes through the 256-byte slot in chunks: an
    f32 all-reduce in ceil(812 / 256) = 4, an all-gather's input likewise;
    every op counted."""
    c = _ranks(world)[0]["counters"]
    assert set(c) == {"all_reduce", "reduce_scatter", "all_gather",
                      "all_to_all", "broadcast"}
    for op, v in c.items():
        assert v["calls"] > 0 and v["chunks"] > v["calls"], (op, v)
    # the f32 all-reduce of 7 x 29 alone: the counters' first calls
    assert math.ceil(7 * 29 * 4 / SLOT) == 4


@pytest.mark.parametrize("world", [2, 3])
def test_refusals_and_shutdown(world):
    """PRODUCT, float64 and a call that mixes devices raise; after
    ``destroy_process_group`` no mailbox is held."""
    for res in _ranks(world):
        assert all(res["refuses"].values()), res["refuses"]
        assert res["memory"]["before"]["cpu"] > 0
        assert res["memory"]["after"] == {"cuda": 0, "cpu": 0}


def test_a_failed_rank_does_not_hang_its_peer():
    """Rank 1 raises after one collective; rank 0's next collective raises
    well inside the store's timeout (60 s) instead of waiting on it."""
    t0 = time.perf_counter()
    rcs, outs = _launch(_CRASH, 2, timeout=90)
    assert rcs[1] != 0 and "rank 1 fails" in outs[1][1]
    assert rcs[0] == 3, outs[0]
    assert time.perf_counter() - t0 < 45
