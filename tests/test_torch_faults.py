"""The port's faults that ``ROADMAP.md`` section 3 listed open, each
repaired, against the reference.

- A stack of no periods: the reduced DeepSeek-V2 cut to its dense prefix
  layer prefills as the reference does, its period caches with a leading
  axis of 0 (``transformer.apply_stack``), and its init draws nothing for
  the periods.
- Microbatches of a sharded step: on 2 data ranks (gloo, in subprocesses,
  ``tests/test_torch_tp.py``'s ``_run_ranks``) an MoE model's microbatch i
  is the global batch's rows, as the reference's ``make_train_step``
  splits it, and a dense model keeps each rank's own rows
  (``sharding/apply.py::_microbatches``).
- The dry run's peak: an MoE cell's falls when its experts split over
  ``model``, and a dense cell's is that of the same step on real tensors
  (``launch/dryrun.py::_untracked_propagation``).
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import cache_leaves, port_cfg
from test_torch_tp import ROOT, _run_ranks

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import train_batch_specs as jax_train_batch
from repro.models import Model as JaxModel
from repro.optim.adamw import init_opt_state as jax_init_opt
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.train_state import TrainState as JaxTrainState
from repro_torch.configs import get_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

TOL = (5e-4, 5e-5)                     # f32 (rtol, atol), the reference's
_DS = "deepseek-v2-236b"


# --------------------------------------------------- a stack of no periods
def test_prefill_of_a_stack_without_periods_matches_reference():
    """The reduced DeepSeek-V2 cut to its dense prefix layer (zero MLA +
    MoE periods): the prefill's logits and caches against the reference's,
    whose scan over zero periods gives every period cache leaf a leading
    axis of 0; the loss and a decode step too."""
    jcfg = jax_get_config(_DS, reduced=True, n_layers=1)
    jm = JaxModel(jcfg)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    tm = Model(port_cfg(jcfg), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert tm.cfg.n_periods == 0
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 8))
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill(tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL[0],
                               atol=TOL[1])
    pairs = cache_leaves(tc, jc)
    assert [t.shape for t, _ in pairs] == [j.shape for _, j in pairs]
    assert [t.shape[0] for t, _ in pairs[:2]] == [0, 0]
    for t, j in pairs:
        np.testing.assert_allclose(t, j, rtol=TOL[0], atol=TOL[1])
    # The init of zero periods draws nothing: the generator stands where
    # the prefix layer's draws left it.
    gens = [torch.Generator().manual_seed(0) for _ in range(2)]
    stack = tf.init_stack(gens[0], tm.cfg)
    for spec in tm.cfg.prefix_pattern:
        tf.init_layer(gens[1], tm.cfg, spec)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert all(t.shape[0] == 0 for t in tree_leaves(stack["periods"]))
    jc2 = jm.init_cache(2, 16)
    tc2 = tm.init_cache(2, 16)
    tok = toks[:, :1]
    jd, _ = jm.decode_step(jparams, jc2, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(0, jnp.int32))
    td, _ = tm.decode_step(tparams, tc2, torch.as_tensor(tok),
                           torch.tensor(0))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL[0],
                               atol=TOL[1])


# ----------------------------------------- microbatches of a sharded step
_MICRO_WORKER = textwrap.dedent(
    """
    import dataclasses, json, pickle, sys, warnings
    warnings.filterwarnings("ignore")
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port, nd, nm, pkl, case = sys.argv[1:8]
    rank, world, nd, nm = int(rank), int(world), int(nd), int(nm)
    case = json.loads(case)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import train_batch_specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model, params_from_numpy
    from repro_torch.sharding import Policy
    from repro_torch.sharding.apply import (distribute_tree, full_tree,
        make_sharded_train_step)
    from repro_torch.train import TrainState, init_train_state
    from repro_torch.tree import tree_leaves

    cfg = get_config(case["arch"], reduced=True)
    model = Model(cfg, device="cpu")
    mesh = make_debug_mesh(nd, nm, device_type="cpu")
    pol = Policy(cfg, mesh)
    with open(pkl, "rb") as f:
        ref = pickle.load(f)
    params = params_from_numpy(ref, "cpu")
    batch = train_batch_specs(cfg, case["batch"], 16, device="cpu")
    # The rows (their tokens) each microbatch's loss reads on this rank.
    rows, real_loss = [], model.loss

    def loss(p, b, *a, **k):
        rows.append(b["tokens"].tolist())
        return real_loss(p, b, *a, **k)

    model.loss = loss
    state = init_train_state(params)
    sstate = TrainState(
        params=distribute_tree(state.params, pol.param_specs(state.params),
                               mesh),
        opt=distribute_tree(state.opt, pol.opt_specs(state.params), mesh))
    sbatch = distribute_tree(batch, pol.batch_specs(batch), mesh)
    sstate, met = make_sharded_train_step(model, mesh, n_micro=2)(sstate,
                                                                  sbatch)
    out = {"rank": rank, "loss": float(met["loss"]), "rows": rows,
           "tokens": batch["tokens"].tolist()}
    for key, tree in (("params", sstate.params), ("m", sstate.opt["m"]),
                      ("v", sstate.opt["v"])):
        out[key] = [t.tolist() for t in tree_leaves(full_tree(tree))]
    print(json.dumps(out))
    dist.destroy_process_group()
    """
)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2-1.5b"])
def test_sharded_microbatches_follow_the_reference(arch, tmp_path_factory):
    """Two microbatches of a train step on 2 data ranks.  The MoE model's
    microbatch i is the global batch's rows [i B / 2, (i + 1) B / 2), each
    rank its half, as the reference's ``make_train_step(n_micro=2)``
    splits the global batch, so its capacities, drops and aux terms are
    the reference's: the loss, parameters and both moments within the f32
    tolerance of the reference's step.  The dense model keeps each rank's
    own rows, and its step is the reference's within the same tolerance
    (the token-weighted sum does not depend on the partition)."""
    jcfg = jax_get_config(arch, reduced=True)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    pkl = tmp_path_factory.mktemp("micro") / "params.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jparams), f)
    b = 8
    batch = jax_train_batch(jcfg, b, 16, concrete=True)
    jstate, jmet = jax_make_train_step(jm, n_micro=2)(
        JaxTrainState(params=jparams, opt=jax_init_opt(jparams)), batch)
    ranks = _run_ranks(2, 1, str(pkl), {"arch": arch, "batch": b},
                       worker=_MICRO_WORKER)
    tokens = np.asarray(ranks[0]["tokens"])
    want = {"params": jax.tree_util.tree_leaves(jstate.params),
            "m": jax.tree_util.tree_leaves(jstate.opt["m"]),
            "v": jax.tree_util.tree_leaves(jstate.opt["v"])}
    moe = get_config(arch, reduced=True).moe is not None
    for r, res in enumerate(ranks):
        for i, got in enumerate(res["rows"]):
            rows = (range(i * b // 2 + r * b // 4, i * b // 2 + (r + 1) * b // 4)
                    if moe else range(r * b // 2 + i * b // 4,
                                      r * b // 2 + (i + 1) * b // 4))
            assert got == tokens[list(rows)].tolist(), (r, i)
        # Held tighter than the f32 tolerance: each rank splitting its own
        # rows missed the reference's loss by 1.6e-4 (6.104191 against
        # 6.104027), inside it.
        assert abs(res["loss"] - float(jmet["loss"])) <= 1e-5 * abs(
            float(jmet["loss"])), (res["loss"], float(jmet["loss"]))
        for key, leaves in want.items():
            for g, w in zip(res[key], leaves, strict=True):
                np.testing.assert_allclose(np.asarray(g, np.float32),
                                           np.asarray(w), rtol=TOL[0],
                                           atol=TOL[1])


# ------------------------------------------------------- the dry run's peak
_PEAK = textwrap.dedent(
    """
    import dataclasses, json, sys
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import debug_mesh_shape
    from repro_torch.tree import tree_map
    arch, d, m, how = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
        sys.argv[4]
    over = json.loads(sys.argv[5])
    cfg = get_config(arch, reduced=True)
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    cfg = dataclasses.replace(cfg, **over)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2 * d,
                                seq_len=8)
    mesh = debug_mesh_shape(d, m)
    if how == "real":
        # The same step on real tensors (zeros): MemTracker's peak there
        # counts what the step allocates; DTensor's sharding propagation
        # runs in a fake mode of its own.
        from torch.distributed._tools.mem_tracker import MemTracker
        from repro_torch.configs.shapes import input_specs
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.model import Model
        from repro_torch.sharding.policy import Policy
        dryrun._fake_group(mesh.size)
        dm = make_mesh(mesh, "cpu")
        dryrun._fake_like = lambda tree: tree_map(
            lambda t: torch.zeros(t.shape, dtype=t.dtype), tree)
        model = Model(dataclasses.replace(cfg, use_pallas=False),
                      device="cpu")
        step, args = dryrun.build_step(model, shape, Policy(cfg, dm),
                                       input_specs(cfg, shape), dm)
        mem = MemTracker()
        mem.track_external(*dryrun._local_tensors(args))
        with mem:
            step(*args)
        peak = max(v["Total"] for v in
                   mem.get_tracker_snapshot("peak").values())
    else:
        peak = dryrun.measure(cfg, shape, mesh)["peak_bytes"]
    print(json.dumps({"peak": peak}))
    """
)


def _peak(arch: str, d: int, m: int, how: str, over: dict) -> int:
    got = subprocess.run(
        [sys.executable, "-c", _PEAK, arch, str(d), str(m), how,
         json.dumps(over)], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                           OMP_NUM_THREADS="1"))
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])["peak"]


def test_dry_run_peak_falls_with_the_expert_split():
    """An MoE cell whose stacked experts outweigh its activations (the
    reduced Qwen1.5-MoE at 8 layers, experts of 256 x 1024, 16 data ranks,
    ``fsdp_tp``): its dry-run peak a device halves when the experts split
    over ``model`` 2.  Before DTensor's sharding propagation was kept out
    of the tracker, its global-shape tensors (every period's experts at
    once, in AdamW) held the peak near the same value whatever the split:
    270359700 against 235888788 B here."""
    over = {"d_model": 256, "n_layers": 8, "sharding_policy": "fsdp_tp",
            "moe": {"d_expert": 1024}}
    peaks = [_peak("qwen2-moe-a2.7b", 16, m, "fake", over) for m in (1, 2)]
    assert peaks[1] < 0.6 * peaks[0], peaks


def test_dry_run_peak_of_a_dense_cell_is_that_on_real_tensors():
    """The reduced Qwen2-1.5B's train step at world size 1: the dry run's
    peak a device is MemTracker's peak of the same step on real tensors
    (2075696 against 2010160 B before the sharding propagation was kept
    out of the tracker)."""
    peaks = {how: _peak("qwen2-1.5b", 1, 1, how, {}) for how in
             ("fake", "real")}
    assert peaks["fake"] == peaks["real"], peaks
