"""The port's sharding policy (``sharding/policy.py``) against the
reference's, spec for spec, and its sharded steps (``sharding/apply.py``)
against the unsharded port step and the reference.

The reference's specs come from ``jax.eval_shape`` trees and a stand-in
mesh (as ``tests/test_sharding.py`` builds them); the port's from the meta
device and a ``MeshShape``, with no process group.  A spec is compared as
the tuple of the ``PartitionSpec``'s entries.  The sharded steps run in
subprocesses on ``gloo`` (2 ranks, and 8 in the slow tier), each rank a
CPU process.
"""

import functools
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import train_batch_specs as jax_train_batch
from repro.models import Model as JaxModel
from repro.sharding.policy import Policy as JaxPolicy
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.launch.mesh import (
    MeshShape,
    debug_mesh_shape,
    production_mesh_shape,
)
from repro_torch.models import Model
from repro_torch.sharding import MeshAxes, Policy
from repro_torch.sharding.policy import is_spec
from repro_torch.tree import tree_flatten, tree_paths

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
P = jax.sharding.PartitionSpec

MESHES = {
    "single": production_mesh_shape(False),
    "multi": production_mesh_shape(True),
    "debug": debug_mesh_shape(2, 4),
}


class _FakeMesh:
    """Just enough Mesh surface for the reference's Policy."""

    def __init__(self, shape: MeshShape):
        self.shape = shape.shape
        self.axis_names = shape.axis_names


def _keystr(path) -> str:
    return "".join(f"['{k}']" if kind == "key" else
                   f"[{k}]" if kind == "index" else f".{k}"
                   for kind, k in path)


def _port_specs(tree, specs) -> dict:
    return {_keystr(p): s for p, s in zip(
        tree_paths(tree), tree_flatten(specs, is_leaf=is_spec)[0],
        strict=True)}


def _ref_specs(specs) -> dict:
    return {jax.tree_util.keystr(path): tuple(spec)
            for path, spec in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))}


@functools.lru_cache(maxsize=None)
def _abstract(arch: str, policy: str | None = None):
    kw = {} if policy is None else {"sharding_policy": policy}
    jcfg, cfg = jax_get_config(arch, **kw), get_config(arch, **kw)
    return (jcfg, JaxModel(jcfg).abstract_params(), cfg,
            Model(cfg, device="meta").abstract_params())


def _policies(arch, mesh="single", policy=None):
    jcfg, jab, cfg, tab = _abstract(arch, policy)
    shape = MESHES[mesh]
    return JaxPolicy(jcfg, _FakeMesh(shape)), jab, Policy(cfg, shape), tab


def _spec_dicts(arch, pkg, mesh="single", policy=None):
    jpol, jab, tpol, tab = _policies(arch, mesh, policy)
    if pkg == "ref":
        return _ref_specs(jpol.param_specs(jab))
    return _port_specs(tab, tpol.param_specs(tab))


# ------------------------------------ tests/test_sharding.py, both packages
PKGS = ("ref", "port")


@pytest.mark.parametrize("pkg", PKGS)
def test_param_specs_qwen3_tp_dims(pkg):
    specs = _spec_dicts("qwen3-8b", pkg)
    wq = next(v for k, v in specs.items()
              if "attn" in k and k.endswith("['wq']"))
    assert wq == (None, "data", "model", None), wq
    tab = next(v for k, v in specs.items() if k.endswith("['table']"))
    assert tab == ("model", "data")


@pytest.mark.parametrize("pkg", PKGS)
def test_param_specs_respect_divisibility(pkg):
    specs = _spec_dicts("granite-34b", pkg)
    wk = next(v for k, v in specs.items() if k.endswith("['wk']"))
    assert wk[2] is None, wk  # 1 kv head: replicated
    wq = next(v for k, v in specs.items() if k.endswith("['wq']"))
    assert wq[2] == "model"   # 48 q heads shard fine


@pytest.mark.parametrize("pkg", PKGS)
def test_param_specs_moe_expert_parallel_vs_expert_tp(pkg):
    specs = _spec_dicts("deepseek-v2-236b", pkg)
    wg = next(v for k, v in specs.items()
              if "moe" in k and "shared" not in k and k.endswith("['w_gate']"))
    assert wg[1] == "model", wg  # 160 experts % 16 == 0: EP
    specs2 = _spec_dicts("qwen2-moe-a2.7b", pkg)
    wg2 = next(v for k, v in specs2.items()
               if "moe" in k and "shared" not in k
               and k.endswith("['w_gate']"))
    assert wg2[1] is None and wg2[3] == "model", wg2  # 60 experts: expert TP


@pytest.mark.parametrize("pkg", PKGS)
def test_multipod_dp_axes(pkg):
    specs = _spec_dicts("qwen3-8b", pkg, mesh="multi")
    wq = next(v for k, v in specs.items()
              if "attn" in k and k.endswith("['wq']"))
    assert wq[1] == ("pod", "data"), wq


@pytest.mark.parametrize("pkg", PKGS)
def test_cache_specs_seq_over_model(pkg):
    jpol, _, tpol, _ = _policies("granite-34b")
    if pkg == "ref":
        caches = jax.eval_shape(
            lambda: JaxModel(jpol.cfg).init_cache(128, 1024))
        specs = _ref_specs(jpol.cache_specs(caches))
    else:
        caches = Model(tpol.cfg, device="meta").init_cache(128, 1024)
        specs = _port_specs(caches, tpol.cache_specs(caches))
    k = next(v for kk, v in specs.items() if kk.endswith(".k"))
    assert k == (None, "data", "model", None, None), k


@pytest.mark.parametrize("pkg", PKGS)
def test_tp_policy_no_dp_on_weights(pkg):
    specs = _spec_dicts("qwen2-1.5b", pkg)  # sharding_policy="tp"
    for key, spec in specs.items():
        assert "data" not in [a for a in spec if isinstance(a, str)], \
            (key, spec)


def test_mesh_axes_and_shapes():
    assert MeshAxes.from_mesh(MESHES["single"]).dp == ("data",)
    assert MeshAxes.from_mesh(MESHES["multi"]).dp == ("pod", "data")
    assert MESHES["single"].size == 256 and MESHES["multi"].size == 512
    assert MESHES["debug"].shape == {"data": 2, "model": 4}


# ------------------------------------------- every leaf, every arch and mesh
@pytest.mark.parametrize("policy", ("tp", "fsdp_tp"))
@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_reference(arch, mesh, policy):
    jpol, jab, tpol, tab = _policies(arch, mesh, policy)
    ref = _ref_specs(jpol.param_specs(jab))
    got = _port_specs(tab, tpol.param_specs(tab))
    assert got == ref
    jopt, topt = jpol.opt_specs(jab), tpol.opt_specs(tab)
    assert tuple(jopt["step"]) == topt["step"] == ()
    for key in ("m", "v"):
        assert _port_specs(tab, topt[key]) == _ref_specs(jopt[key])


@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_reference(arch, mesh):
    jpol, _, tpol, _ = _policies(arch, mesh)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        ref_in = jax_input_specs(jpol.cfg, JAX_SHAPES[name], concrete=False)
        got_in = input_specs(tpol.cfg, SHAPES[name])
        if name == "decode_32k":
            pairs = (("inputs", "batch_specs"), ("caches", "cache_specs"))
        else:
            pairs = (("batch", "batch_specs"),)
        for key, fn in pairs:
            ref = _ref_specs(getattr(jpol, fn)(ref_in[key]))
            got = _port_specs(got_in[key], getattr(tpol, fn)(got_in[key]))
            if not isinstance(got_in[key], dict):      # a bare token array
                got = {"": got[""]}
            assert got == ref, (name, key)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding import to_placements

    multi = MESHES["multi"]
    assert to_placements((None, ("pod", "data"), "model"), multi) == [
        Shard(1), Shard(1), Shard(2)]
    assert to_placements((None,), multi) == [Replicate()] * 3
    assert to_placements(("model", "data"), MESHES["single"]) == [
        Shard(1), Shard(0)]


# ------------------------------------------------------ sharded-step parity
_WORKER = textwrap.dedent(
    """
    import dataclasses, json, pickle, sys, warnings
    warnings.filterwarnings("ignore")
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port, arch, nd, nm, pkl, steps = sys.argv[1:9]
    rank, world, nd, nm, steps = int(rank), int(world), int(nd), int(nm), \\
        int(steps)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import decode_input_specs, \\
        train_batch_specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model, params_from_numpy
    from repro_torch.sharding import Policy
    from repro_torch.sharding.apply import (distribute_tree, full_tree,
        make_sharded_decode_step, make_sharded_train_step)
    from repro_torch.train import (TrainState, init_train_state,
        make_decode_step, make_train_step)
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              sharding_policy="fsdp_tp")
    model = Model(cfg, device="cpu")
    mesh = make_debug_mesh(nd, nm, device_type="cpu")
    pol = Policy(cfg, mesh)
    if pkl != "-":
        with open(pkl, "rb") as f:
            ref = pickle.load(f)
        init = lambda: params_from_numpy(ref, "cpu")
    else:
        init = lambda: model.init(0)
    b = 2 * nd * nm
    batch = train_batch_specs(cfg, b, 16, device="cpu")
    out = {}

    state = init_train_state(init())
    sstate = TrainState(
        params=distribute_tree(state.params, pol.param_specs(state.params),
                               mesh),
        opt=distribute_tree(state.opt, pol.opt_specs(state.params), mesh))
    sbatch = distribute_tree(batch, pol.batch_specs(batch), mesh)
    sstep = make_sharded_train_step(model, mesh)
    losses = []
    for _ in range(steps):
        sstate, met = sstep(sstate, sbatch)
        losses.append(float(met["loss"]))
    out["losses"] = losses
    if steps == 1:
        ustate, umet = make_train_step(model)(init_train_state(init()), batch)
        out["loss_unsharded"] = float(umet["loss"])
        for key, s, u in (("params", sstate.params, ustate.params),
                          ("m", sstate.opt["m"], ustate.opt["m"]),
                          ("v", sstate.opt["v"], ustate.opt["v"])):
            out[key] = [float(((a - c).abs() - 5e-4 * c.abs()).max())
                        for a, c in zip(tree_leaves(full_tree(s)),
                                        tree_leaves(u), strict=True)]

    params = full_tree(sstate.params)
    inputs, caches, _ = decode_input_specs(cfg, b, 16, device="cpu")
    scaches = distribute_tree(caches, pol.cache_specs(caches), mesh)
    sinputs = distribute_tree(inputs, pol.batch_specs(inputs), mesh)
    dstep, sdstep = make_decode_step(model), make_sharded_decode_step(
        model, mesh)
    toks, stoks, finite = [], [], True
    for i in range(4):
        pos = torch.tensor(i, dtype=torch.int32)
        lg, caches = dstep(params, caches, inputs, pos)
        slg, scaches = sdstep(sstate.params, scaches, sinputs, pos)
        slg = slg.full_tensor()
        finite &= bool(torch.isfinite(slg).all())
        toks.append(torch.argmax(lg[:, 0], -1).tolist())
        stoks.append(torch.argmax(slg[:, 0], -1).tolist())
        inputs = torch.argmax(lg[:, 0], -1, keepdim=True).to(torch.int32)
        sinputs = distribute_tree(inputs, pol.batch_specs(inputs), mesh)
    out.update(tokens=toks, sharded_tokens=stoks, finite=finite)
    if rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(arch: str, nd: int, nm: int, pkl: str, steps: int,
               timeout: int) -> dict:
    world = nd * nm
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(port), arch,
         str(nd), str(nm), pkl, str(steps)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs, strict=True):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b"])
def test_sharded_train_step_matches_unsharded_and_reference(arch, mesh,
                                                            tmp_path):
    """fsdp_tp on 2 gloo ranks: one train step's loss, parameters and
    moments within f32 tolerance of the unsharded port step on the same
    global batch, the loss within it of the reference's on the same
    weights; decode tokens on the mesh equal the unsharded ones."""
    import dataclasses

    nd, nm = mesh
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               sharding_policy="fsdp_tp")
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    pkl = tmp_path / "params.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jparams), f)
    res = _run_ranks(arch, nd, nm, str(pkl), steps=1, timeout=240)
    batch = jax_train_batch(jcfg, 2 * nd * nm, 16, concrete=True)
    ref_loss = float(jm.loss(jparams, batch)[0])
    (loss,) = res["losses"]
    assert abs(loss - res["loss_unsharded"]) <= 5e-5 + 5e-4 * abs(
        res["loss_unsharded"])
    assert abs(loss - ref_loss) <= 5e-5 + 5e-4 * abs(ref_loss)
    for key in ("params", "m", "v"):
        assert max(res[key]) <= 5e-5, key
    assert res["finite"]
    assert res["sharded_tokens"] == res["tokens"]


@pytest.mark.slow  # 8 CPU processes per arch, ~30 s each
@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-v0.1-52b",
                                  "deepseek-v2-236b"])
def test_sharded_execution_on_8_ranks(arch):
    """The counterpart of ``test_sharded_execution_on_8_devices``: a (2, 4)
    mesh of 8 gloo ranks, two sharded train steps, then decode on the
    mesh."""
    res = _run_ranks(arch, 2, 4, "-", steps=2, timeout=540)
    loss, loss2 = res["losses"]
    assert np.isfinite(loss)
    assert loss2 < loss * 1.2
    assert res["finite"]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b"])
def test_sharded_steps_at_world_size_1_are_the_unsharded_steps(arch,
                                                                tmp_path):
    """On a (1, 1) mesh every collective is the identity: the sharded
    train step (one batch and two microbatches), prefill and decode give
    the unsharded steps' bits, as ``chip_smoke.py`` phase 25 holds them on
    the card."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.shapes import (
        decode_input_specs,
        prefill_batch_specs,
        train_batch_specs,
    )
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.apply import (
        distribute_tree,
        local_tree,
        make_sharded_decode_step,
        make_sharded_prefill_step,
        make_sharded_train_step,
    )
    from repro_torch.train import (
        TrainState,
        init_train_state,
        make_decode_step,
        make_prefill_step,
        make_train_step,
    )
    from repro_torch.tree import tree_leaves, tree_map

    def same(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(
            torch.equal(x, y) for x, y in zip(la, lb))

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  sharding_policy="fsdp_tp")
        model = Model(cfg, device="cpu")
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        pol = Policy(cfg, mesh)
        batch = train_batch_specs(cfg, 4, 16, device="cpu")
        for n_micro in (1, 2):
            want, wmet = make_train_step(model, n_micro=n_micro)(
                init_train_state(model.init(0)), batch)
            st = init_train_state(model.init(0))
            st = TrainState(
                params=distribute_tree(st.params,
                                       pol.param_specs(st.params), mesh),
                opt=distribute_tree(st.opt, pol.opt_specs(st.params), mesh))
            got, gmet = make_sharded_train_step(model, mesh, n_micro=n_micro)(
                st, distribute_tree(batch, pol.batch_specs(batch), mesh))
            assert torch.equal(gmet["loss"], wmet["loss"]), n_micro
            assert torch.equal(gmet["grad_norm"], wmet["grad_norm"])
            assert same(local_tree(got.params), want.params)
            assert same(local_tree(got.opt["m"]), want.opt["m"])
            assert same(local_tree(got.opt["v"]), want.opt["v"])
        params = model.init(0)
        sparams = distribute_tree(params, pol.param_specs(params), mesh)
        pb = prefill_batch_specs(cfg, 2, 16, device="cpu")
        lg, caches = make_prefill_step(model)(params, pb)
        slg, scaches = make_sharded_prefill_step(model, mesh)(
            sparams, distribute_tree(pb, pol.batch_specs(pb), mesh))
        assert torch.equal(slg.to_local(), lg)
        assert same(local_tree(scaches), caches)
        inputs, caches, pos = decode_input_specs(cfg, 2, 16, device="cpu")
        scaches = distribute_tree(
            tree_map(torch.clone, caches), pol.cache_specs(caches), mesh)
        sinputs = distribute_tree(inputs, pol.batch_specs(inputs), mesh)
        for i in range(3):
            p = torch.tensor(i, dtype=torch.int32)
            lg, caches = make_decode_step(model)(params, caches, inputs, p)
            slg, scaches = make_sharded_decode_step(model, mesh)(
                sparams, scaches, sinputs, p)
            assert torch.equal(slg.to_local(), lg)
        assert same(local_tree(scaches), caches)
    finally:
        dist.destroy_process_group()
