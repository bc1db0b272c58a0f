"""The training step's memory: the stacked gradient a period at a time, and
``global_norm`` a slice at a time, against the routes they replace.

- (a) A grain's gradient on the reduced Mamba2 and on a reduced dense
  config (Qwen2's), 8 periods each, in f32 and bf16: every leaf's bytes
  equal to those of the route the port took before, each period's
  parameters as ``unbind`` views whose backward stacks the periods'
  gradients (``_unbind_route``, kept here); and on a small stack whose
  gradients hold -0.0 and a period that leaves a leaf unused, byte for
  byte ``unbind``'s.
- (b) MemTracker's peak over that backward: lower than the ``unbind``
  route's by at least half the largest stacked leaf less one period, and
  by at least 0.75 of one period.  ``unbind``'s node (one a leaf, made
  before the forward) runs last, so that route holds every period's
  gradient of every stacked leaf and stacks them a leaf at a time: its
  peak is the gradients it ends with plus the largest stacked leaf.  The
  ``_PeriodRows`` route holds the stacked gradients from the backward's
  first period on, so its peak is the gradients it ends with plus one
  period plus the backward's own temporaries there (a period's
  activation gradients): at these widths those are some 40% of the
  largest leaf less a period in Mamba2's bf16 case (measured falls 0.60
  to 0.97 of it), hence the half.  At the published widths the pool of
  the graph on the card is held by ``test_torch_cuda.py``'s
  ``test_grain_graph_pool_holds_no_period_gradients``.  The dense config
  keeps Qwen2-1.5B's MLP width to model width (8960 / 1536, about 5.8;
  384 / 64 here), so that its MLP leaves hold most of a period, as at
  the published widths.
- (c) ``global_norm``: within the reference's f32 tolerance of
  ``repro.optim.adamw.global_norm`` on the same numpy leaves, bf16 and
  f32, with leaves of several slices (``SLICE`` made small); at most one
  slice of widened bytes beside the leaves (MemTracker); on gloo ranks in
  subprocesses, a tree of DTensors at mesh (1, 1) the plain tree's bits,
  and at (1, 2) and (2, 1), leaves sharded and replicated, within the f32
  tolerance (a replicated leaf counted once); a ``Partial`` leaf, and
  leaves on two meshes, raise.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_tp import ROOT, _free_port
from torch.distributed._tools.mem_tracker import MemTracker

from repro.optim.adamw import global_norm as jax_global_norm
from repro_torch.configs import get_config
from repro_torch.data import GrainSpec, SyntheticSource, batch_from_grains
from repro_torch.models import Model
from repro_torch.models.parallel import (
    Parallel,
    stacked_periods,
    unbind_periods,
)
from repro_torch.optim import adamw
from repro_torch.train.step import make_grain_grad_fn
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

torch.set_num_threads(1)

TOL = (5e-4, 5e-5)                     # f32 (rtol, atol), the reference's
PERIODS = 8
SEQ = 8
#: (arch, overrides): the reduced Mamba2, and the reduced Qwen2 at the
#: published MLP-to-model width ratio.
CONFIGS = {"mamba2": ("mamba2-2.7b", {}),
           "dense": ("qwen2-1.5b", {"d_ff": 384})}


class _UnbindParallel(Parallel):
    """The parent's period provider: ``unbind`` views of every period,
    made before the forward."""

    def periods(self, periods):
        return unbind_periods(periods), lambda tree: tree


def _model(name: str, dtype: str) -> Model:
    arch, over = CONFIGS[name]
    cfg = get_config(arch, reduced=True, n_layers=PERIODS, param_dtype=dtype,
                     compute_dtype=dtype, **over)
    return Model(cfg, device="cpu")


def _batch(model: Model) -> dict:
    spec = GrainSpec(1, SEQ, model.cfg.vocab_size)
    return batch_from_grains(SyntheticSource(spec, seed=0), 0, [0], spec,
                             device="cpu")


def _unbind_route(model: Model, params, batch):
    """The grain's gradients through ``unbind``'s stacking backward, as
    the port computed them before."""
    leaves, treedef = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, leaves), batch,
                         par=_UnbindParallel())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, leaves, strict=True)]


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy() \
        .tobytes()


def _backward_peak(model: Model, params, batch, par) -> int:
    leaves, treedef = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, leaves), batch, par=par)
    mem = MemTracker()
    mem.track_external(*leaves)
    with mem:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    del grads
    return max(v["Total"] for v in mem.get_tracker_snapshot("peak").values())


# ------------------------------------------ (a) the stacked gradient's bits
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_grain_gradient_keeps_the_unbind_routes_bytes(name, dtype):
    model = _model(name, dtype)
    params = model.init(0)
    batch = _batch(model)
    want = _unbind_route(model, params, batch)
    (_, _), grads = make_grain_grad_fn(model, compile_steps=False)(
        params, batch)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert _bytes(g) == _bytes(w), f"leaf {i} {tuple(g.shape)}"


def test_periods_without_autograd_are_the_stacks_views():
    """Prefill and decode (no gradient) read each period as a view of the
    stack, with no autograd node, as before."""
    stack = {"w": torch.arange(24.0).reshape(4, 2, 3)}
    with torch.no_grad():
        periods = list(stacked_periods(stack))
    assert len(periods) == 4
    for t, p in enumerate(periods):
        assert p["w"].grad_fn is None
        assert p["w"].data_ptr() == stack["w"][t].data_ptr()


def test_signed_zeros_and_unused_periods_keep_unbinds_bytes():
    """On a stack whose gradients hold -0.0 (``c``, multiplied by 0.0 under
    a minus) and a period that leaves a leaf unused (``b`` in period 1,
    +0.0 in that row, as ``unbind``'s backward fills an undefined
    gradient), every leaf's gradient is ``unbind``'s, byte for byte."""
    gen = torch.Generator().manual_seed(1)
    stack = {k: torch.randn(3, 4, generator=gen) for k in "abc"}

    def grads(periods):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in stack.items()}
        loss = 0.0
        for t, p in enumerate(periods(leaves)):
            loss = loss + (p["a"] * p["a"]).sum() - (p["c"] * 0.0).sum()
            if t != 1:
                loss = loss - p["b"].sum()
        return torch.autograd.grad(loss, list(leaves.values()))

    want = grads(unbind_periods)
    got = grads(stacked_periods)
    assert torch.signbit(want[2]).all() and not want[1][1].any()
    for g, w in zip(got, want, strict=True):
        assert _bytes(g) == _bytes(w)


# ------------------------------------------------ (b) the backward's peak
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_backward_peak_falls_by_most_of_a_period(name, dtype):
    model = _model(name, dtype)
    params = model.init(0)
    batch = _batch(model)
    sizes = [x.numel() * x.element_size()
             for x in tree_leaves(params["stack"]["periods"])]
    period = sum(sizes) / PERIODS
    old = _backward_peak(model, params, batch, _UnbindParallel())
    new = _backward_peak(model, params, batch, Parallel())
    assert old - new >= 0.75 * period, (old, new, period)
    assert old - new >= 0.5 * (max(sizes) - period), (old, new, max(sizes))


# ---------------------------------------------------------- (c) global_norm
def _leaves(rng, sizes, dtype):
    """Seeded numpy leaves of ``sizes`` (shapes), rounded to ``dtype``."""
    out = []
    for shape in sizes:
        x = rng.standard_normal(shape).astype(np.float32)
        if dtype == "bfloat16":
            x = x.astype(ml_dtypes.bfloat16)
        out.append(x)
    return out


def _torch_leaf(x) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


SHAPES = [(), (7,), (3, 5), (5, 1024), (3, 4, 1000), (2049,)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
def test_global_norm_matches_reference(dtype, monkeypatch):
    monkeypatch.setattr(adamw, "SLICE", 1 << 10)
    rng = np.random.default_rng(3)
    if dtype == "mixed":
        leaves = (_leaves(rng, SHAPES[:3], "float32")
                  + _leaves(rng, SHAPES[3:], "bfloat16"))
    else:
        leaves = _leaves(rng, SHAPES, dtype)
    want = float(jax_global_norm([jnp.asarray(x) for x in leaves]))
    got = adamw.global_norm({"leaves": [_torch_leaf(x) for x in leaves]})
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=TOL[0], atol=TOL[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_norm_widens_at_most_one_slice(dtype, monkeypatch):
    slice_ = 1 << 12
    monkeypatch.setattr(adamw, "SLICE", slice_)
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(5 * slice_ + 7, generator=gen).to(dtype),
              torch.randn(3, slice_, generator=gen).to(dtype)]
    mem = MemTracker()
    mem.track_external(*leaves)
    with mem:
        mem.reset_mod_stats()
        adamw.global_norm(leaves)
    peak = max(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    held = sum(x.numel() * x.element_size() for x in leaves)
    # The leaves, one f32 slice and a few 4-byte sums.
    assert peak - held <= 4 * slice_ + 64, peak - held


_RANKS = textwrap.dedent(
    """
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import debug_mesh_shape, make_mesh
    from repro_torch.optim import adamw
    rank, world, port, nd, nm = map(int, sys.argv[1:6])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    adamw.SLICE = 1 << 10
    mesh = make_mesh(debug_mesh_shape(nd, nm), "cpu")
    gen = torch.Generator().manual_seed(7)
    full = [torch.randn(4, 3000, generator=gen),
            torch.randn(8, 700, generator=gen).to(torch.bfloat16),
            torch.randn(6, 5, generator=gen),
            torch.randn(2500, generator=gen).to(torch.bfloat16),
            torch.randn((), generator=gen)]
    places = [[Replicate(), Shard(0)], [Shard(0), Shard(1)],
              [Replicate(), Replicate()], [Shard(0), Replicate()],
              [Replicate(), Replicate()]]
    tree = [distribute_tensor(x, mesh, p, src_data_rank=None)
            for x, p in zip(full, places)]
    got = adamw.global_norm(tree)
    want = adamw.global_norm(full)
    local = got.to_local()
    raised = []
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial
    other = init_device_mesh("cpu", (world,))
    for bad in ([DTensor.from_local(full[2], mesh, [Partial(), Replicate()],
                                    run_check=False)],
                [tree[0], distribute_tensor(full[2], other, [Replicate()],
                                            src_data_rank=None)]):
        try:
            adamw.global_norm(bad)
            raised.append(False)
        except ValueError:
            raised.append(True)
    print(json.dumps({"got": float(local), "want": float(want),
                      "raised": raised,
                      "same_bits": bool(torch.equal(
                          local.view(torch.int32), want.view(torch.int32))),
                      "replicated": [p.is_replicate()
                                     for p in got.placements]}))
    dist.destroy_process_group()
    """
)


def _norm_ranks(nd: int, nm: int) -> list[dict]:
    world, port = nd * nm, _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANKS, str(r), str(world), str(port),
         str(nd), str(nm)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs, strict=True):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


@pytest.mark.parametrize("mesh", [(1, 1), (1, 2), (2, 1)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_global_norm(mesh):
    res = _norm_ranks(*mesh)
    for r in res:
        assert all(r["replicated"])
        assert r["raised"] == [True, True]      # Partial; two meshes
        np.testing.assert_allclose(r["got"], r["want"], rtol=1e-6)
        assert r["got"] == res[0]["got"]
    if mesh == (1, 1):
        assert res[0]["same_bits"]
