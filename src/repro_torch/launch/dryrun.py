"""Multi-pod dry run: one sharded step per (arch x shape x mesh) cell, on
fake tensors under a fake process group.

Port of ``repro/launch/dryrun.py``.  For each cell this:
  1. sets up ``torch.distributed`` with the ``fake`` backend at the mesh's
     world size (256 single-pod, 512 multi-pod; this process is rank 0) and
     the production mesh on top (``launch/mesh.py``),
  2. builds abstract params, AdamW moments and inputs under
     ``FakeTensorMode`` (nothing allocated) and places them by the policy
     (``sharding/policy.py``, ``sharding/apply.py::distribute_tree``),
  3. runs the cell's sharded step (``sharding/apply.py``) once, on the
     model's plain path (``use_pallas=False``), as the reference's dry run
     ends on its plain path on CPU host devices — success shows the
     distribution config is coherent (divisibility, placements, every
     collective),
  4. records into ``<out>/<arch>__<shape>__<mesh>[__tag].json``:
     - FLOPs a device (``torch.utils.flop_counter.FlopCounterMode``),
     - bytes a device: the tensor bytes every dispatched op reads and
       writes (eager ops, no fusion: an upper bound of the memory traffic),
     - collectives a device (``CommDebugMode``, each op's result bytes and
       group size), turned into bytes by the reference's ring model
       (``collective_stats``),
     - peak bytes a device (``torch.distributed._tools.mem_tracker.
       MemTracker``; DTensor's sharding propagation, which runs each op
       once more on fake tensors of the global shapes to learn its output's
       metadata, is kept out of it: ``_untracked_propagation``) and
       argument bytes (the local shards of the state and inputs),
     - ``model_flops`` (6N / 2N active parameters) and the roofline terms
       against the H100's figures (``HW``), with ``dominant`` and
       ``useful_flops_ratio``.

No counterpart: the reference parses the compiled HLO (``cost_dict``,
``_shape_bytes``, collective lines) and extrapolates 1- and 2-period
unrolled compiles to the full depth, because XLA's cost analysis visits a
scanned period once.  Here every number comes from PyTorch's own counters
on the executed step, which runs every period, so nothing is extrapolated.
The step is the one a run would take (``sharding/apply.py``): tensor-
parallel over ``model`` for attention, MLA, cross-attention, dense-MLP,
MoE, Mamba, embedding and head leaves (each device computes its heads, MLP
columns, experts and vocabulary rows, and a decode attends over its own
share of the cache's sequence), a layer whose count does not divide whole
on each ``model`` device; so ``useful_flops_ratio`` and the collectives
count what that split does.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  ... --set sharding_policy=fsdp_tp --tag fsdp      (config overrides)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, SHAPES, ShapeSpec, cell_status, get_config
from ..configs.shapes import input_specs
from ..models.model import Model
from ..sharding.policy import Policy, leaf_names
from ..tree import tree_flatten, tree_map, tree_paths
from .mesh import HW, MeshShape, make_mesh, production_mesh_shape

__all__ = ["MESHES", "collective_stats", "model_flops", "measure",
           "run_cell", "main"]

#: The dry run's meshes by name: the production pods.
MESHES = {
    "single": production_mesh_shape(multi_pod=False),
    "multi": production_mesh_shape(multi_pod=True),
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: Functional-collective op names -> the reference's HLO collective names.
_OP_NAMES = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"), ("broadcast", "collective-permute"),
)


def collective_stats(records: list[dict]) -> dict:
    """Per-device collective bytes, ring model over each record's ``op``,
    result ``bytes`` r and ``group`` size g (records of a group of one
    move nothing):
    all-gather/all-to-all: r*(g-1)/g ; reduce-scatter: r*(g-1) ;
    all-reduce: 2*r*(g-1)/g ; collective-permute: r."""
    per_op: dict[str, float] = {c: 0.0 for c in _COLLECTIVES}
    counts: dict[str, int] = {c: 0 for c in _COLLECTIVES}
    top: list[tuple] = []
    for rec in records:
        op, r, g = rec["op"], rec["bytes"], rec["group"]
        if g <= 1:
            continue
        if op in ("all-gather", "all-to-all"):
            b = r * (g - 1) / g
        elif op == "reduce-scatter":
            b = r * (g - 1)
        elif op == "all-reduce":
            b = 2 * r * (g - 1) / g
        else:
            b = r
        per_op[op] += b
        counts[op] += 1
        top.append((b, f"{op} g={g} {rec.get('what', '')}"[:160]))
    top.sort(key=lambda x: -x[0])
    return {
        "bytes_per_device": sum(per_op.values()),
        "per_op_bytes": per_op,
        "per_op_counts": counts,
        "top_ops": [{"bytes": b, "what": w} for b, w in top[:12]],
    }


def model_flops(cfg, model: Model, shape, n_tokens: int, kind: str):
    """6*N_active*D (train) / 2*N_active*D (inference); N counts
    non-embedding params with routed experts scaled by top_k/E, plus the LM
    head.  Returns (flops, {"params_total", "params_active"})."""
    abstract = model.abstract_params()
    total = routed = embed = 0
    for path, leaf in zip(tree_paths(abstract), tree_flatten(abstract)[0],
                          strict=True):
        names = leaf_names(path, kinds=("key",))
        n = math.prod(leaf.shape)
        total += n
        if "moe" in names and names[-1] in ("w_gate", "w_up", "w_down") \
                and "shared" not in names:
            routed += n
        if "embed" in names and names[-1] == "table":
            embed += n
    active = total - embed
    if cfg.moe:
        active -= routed * (1 - cfg.moe.top_k / cfg.moe.n_routed)
    if cfg.tie_embeddings:
        active += embed  # tied head matmul still costs flops
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * n_tokens, {"params_total": total,
                                      "params_active": active}


def _collective_mode():
    """A ``CommDebugMode`` that also records each collective's result
    bytes, group size and group name (``.records``)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor.debug import CommDebugMode

    class _Recorder(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.records: list[dict] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or not hasattr(func, "_overloadpacket"):
                return out
            name = str(func._overloadpacket)
            if "c10d" not in name:
                return out
            op = next((hlo for key, hlo in _OP_NAMES if key in name), None)
            if op is None:
                return out
            # The group's name is the op's last string argument (a
            # reduce op's name comes before it).
            group = next((a for a in reversed(list(args) + list(
                (kwargs or {}).values())) if isinstance(a, str)), None)
            g = _resolve_process_group(group).size() if group else 1
            t = out[0] if isinstance(out, (list, tuple)) else out
            self.records.append({
                "op": op, "bytes": t.numel() * t.element_size(), "group": g,
                "pg": group,
                "what": f"{name} {tuple(t.shape)} {str(t.dtype)[6:]}"})
            return out

    return _Recorder()


class _ByteCounter(TorchDispatchMode):
    """The tensor bytes every op reads and writes; views and
    communication move none here (collectives are counted apart)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(getattr(func, "_overloadpacket", ""))
        if "c10d" in name or func.is_view:
            return out
        for t in tree_flatten([list(args), kwargs or {}, out])[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def _local_tensors(tree) -> list:
    """Each tensor leaf of ``tree``, a DTensor's local shard for it."""
    from torch.distributed.tensor import DTensor

    return [leaf.to_local() if isinstance(leaf, DTensor) else leaf
            for leaf in tree_flatten(tree)[0]
            if isinstance(leaf, torch.Tensor)]


def _local_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _local_tensors(tree))


def _fake_like(tree):
    """Fake CPU tensors of a meta tree's shapes and dtypes (call under a
    ``FakeTensorMode``)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


@contextlib.contextmanager
def _untracked_propagation():
    """DTensor's sharding propagation run outside the dry run's fake mode.

    To learn an op's output shape DTensor runs the op on fake tensors of
    the global shapes, under the fake mode it finds active (``_sharding_
    prop.py``).  Under the dry run's mode ``MemTracker`` counts those
    tensors as the step's own: a whole expert stack or vocabulary table,
    several times, at the first op of each shape, which set the peak of
    every cell whatever the split (an MoE cell's peak stayed put while its
    experts split over ``model``).  In a fake mode of its own the
    propagation allocates nothing the tracker sees, as in an eager step
    on real tensors, where it makes a fake mode of its own too."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    real = ShardingPropagator._propagate_tensor_meta_non_cached

    def apart(self, op_schema):
        with unset_fake_temporarily():
            return real(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = apart
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = real


def _fake_group(world_size: int) -> None:
    """A ``fake`` process group of ``world_size`` ranks (this process is
    rank 0), replacing a fake group of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: a "
                               f"{dist.get_backend()} group is set up")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def build_step(model: Model, shape: ShapeSpec, policy: Policy, specs: dict,
               mesh, n_micro: int = 1):
    """(step, args) for the shape's kind: the sharded step of
    ``sharding/apply.py`` and its placed fake arguments (call under a
    ``FakeTensorMode``)."""
    kind = shape.kind
    from ..sharding.apply import (
        distribute_tree,
        make_sharded_decode_step,
        make_sharded_prefill_step,
        make_sharded_train_step,
    )
    from ..train.train_state import TrainState

    abstract = model.abstract_params()
    params = _fake_like(abstract)
    sparams = distribute_tree(params, policy.param_specs(abstract), mesh)
    if kind == "train":
        opt = {"m": tree_map(lambda t: torch.empty(t.shape), abstract),
               "v": tree_map(lambda t: torch.empty(t.shape), abstract),
               "step": torch.zeros((), dtype=torch.int32)}
        state = TrainState(params=sparams, opt=distribute_tree(
            opt, policy.opt_specs(abstract), mesh))
        batch = _fake_like(specs["batch"])
        return (make_sharded_train_step(model, mesh, n_micro=n_micro),
                (state, distribute_tree(batch, policy.batch_specs(batch),
                                        mesh)))
    if kind == "prefill":
        batch = _fake_like(specs["batch"])
        return (make_sharded_prefill_step(model, mesh),
                (sparams, distribute_tree(batch, policy.batch_specs(batch),
                                          mesh)))
    caches = _fake_like(specs["caches"])
    inputs = _fake_like(specs["inputs"])
    # One position for every row, as a (B,) vector: a fake scalar's value
    # is lost at its first view, and the cache write needs it on the host.
    b = tree_flatten(inputs)[0][0].shape[0]
    pos = torch.full((b,), shape.seq_len - 1, dtype=torch.int32)
    return (make_sharded_decode_step(model, mesh),
            (sparams, distribute_tree(caches, policy.cache_specs(caches),
                                      mesh),
             distribute_tree(inputs, policy.batch_specs(inputs), mesh),
             distribute_tree(pos, policy.batch_specs(pos), mesh)))


def measure(cfg, shape: ShapeSpec, mesh_shape: MeshShape,
            n_micro: int = 1) -> dict:
    """One sharded step of ``cfg`` at ``shape`` on a mesh of
    ``mesh_shape`` under a fake process group: per-device FLOPs, bytes,
    collectives, peak and argument bytes, and the step's seconds on the
    host."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    _fake_group(mesh_shape.size)
    mesh = make_mesh(mesh_shape, "cpu")
    cfg = dataclasses.replace(cfg, use_pallas=False)
    model = Model(cfg, device="cpu")
    policy = Policy(cfg, mesh)
    specs = input_specs(cfg, shape)
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = build_step(model, shape, policy, specs, mesh, n_micro)
        arg_bytes = _local_bytes(args)
        mem = MemTracker()
        mem.track_external(*_local_tensors(args))   # the peak holds them
        flops = FlopCounterMode(display=False)
        comm = _collective_mode()
        counter = _ByteCounter()
        t0 = time.perf_counter()
        with _untracked_propagation(), mem, comm, flops, counter:
            out = step(*args)
        run_s = time.perf_counter() - t0
        out_bytes = _local_bytes(out)
        peak = max(v["Total"] for v in
                   mem.get_tracker_snapshot("peak").values())
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes),
            "coll": collective_stats(comm.records),
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "peak_bytes": peak, "run_s": run_s, "n_devices": mesh_shape.size}


def run_cell(
    arch: str, shape_name: str, mesh_kind: str, out_dir: str,
    overrides: dict | None = None, tag: str = "", n_micro: int = 1,
) -> dict:
    """Dry-run one cell and write its JSON."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch, **(overrides or {}))
    status = cell_status(cfg, shape)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "status": status,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
    }
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh_kind}{'__' + tag if tag else ''}.json"
    path = os.path.join(out_dir, fname)
    if status != "run":
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        return result

    m = measure(cfg, shape, MESHES[mesh_kind], n_micro)
    n_tokens = shape.global_batch * (1 if shape.kind == "decode"
                                     else shape.seq_len)
    if cfg.is_enc_dec and shape.kind != "decode":
        n_tokens = shape.global_batch * shape.seq_len // 2  # decoder tokens
    mf, pstats = model_flops(cfg, Model(cfg, device="meta"), shape, n_tokens,
                             shape.kind)
    chips = m["n_devices"]
    compute_s = m["flops"] / HW["peak_flops_bf16"]
    memory_s = m["bytes"] / HW["hbm_bw"]
    collective_s = m["coll"]["bytes_per_device"] / HW["nvlink_bw"]
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1])[0]
    result.update({
        "n_devices": chips,
        "run_s": round(m["run_s"], 2),
        "memory": {"argument_bytes": m["argument_bytes"],
                   "output_bytes": m["output_bytes"],
                   "peak_bytes": m["peak_bytes"]},
        "cost_flops_per_device": m["flops"],
        "cost_bytes_per_device": m["bytes"],
        "collectives": m["coll"],
        "model_flops_total": mf,
        "params": pstats,
        "tokens": n_tokens,
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": dominant,
            "useful_flops_ratio": mf / max(m["flops"] * chips, 1.0),
        },
    })
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def _parse_val(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for kind in (int, float):
        try:
            return kind(v)
        except ValueError:
            pass
    return v


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument(
        "--set", action="append", default=[],
        help="ModelConfig overrides key=value (e.g. sharding_policy=fsdp_tp)",
    )
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--n-micro", type=int, default=1,
                    help="microbatch accumulation steps inside train_step")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = _parse_val(v)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape, mk) for arch in ARCH_IDS for shape in SHAPES
                 for mk in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required without --all")
        cells = [(args.arch, args.shape, mk) for mk in meshes]

    failures = []
    for arch, shape_name, mk in cells:
        fname = (f"{arch}__{shape_name}__{mk}"
                 f"{'__' + args.tag if args.tag else ''}.json")
        if args.skip_existing and os.path.exists(os.path.join(args.out,
                                                              fname)):
            print(f"[skip existing] {fname}")
            continue
        print(f"=== {arch} x {shape_name} x {mk} ===", flush=True)
        try:
            res = run_cell(arch, shape_name, mk, args.out, overrides,
                           args.tag, n_micro=args.n_micro)
            if res["status"] != "run":
                print(f"  SKIPPED: {res['status']}")
                continue
            r = res["roofline"]
            print(
                f"  ok  run={res['run_s']}s  "
                f"flops/dev={res['cost_flops_per_device']:.3e}  "
                f"bytes/dev={res['cost_bytes_per_device']:.3e}  "
                f"coll_bytes/dev={res['collectives']['bytes_per_device']:.3e}"
                f"  peak/dev={res['memory']['peak_bytes']:.3e}  "
                f"terms(c/m/x)=({r['compute_s']:.4f}/{r['memory_s']:.4f}/"
                f"{r['collective_s']:.4f})s dominant={r['dominant']}",
                flush=True,
            )
        except Exception as e:
            failures.append((arch, shape_name, mk, repr(e)))
            print(f"  FAILED: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall cells green")


if __name__ == "__main__":
    main()
