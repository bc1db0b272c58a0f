"""Port parity: checkpoints cross-load between the port and the JAX package.

Both packages write ``step_N/{arrays.npz,tree.json,extras.json}`` with the
leaves in ``jax.tree_util``'s order as raw uint8 bytes.  A train state with
bf16 params, f32 moments and an int32 step saved by one restores bit for
bit in the other (the port maps the dtype name "bfloat16" itself, without
``ml_dtypes``), ``tree.json`` is the same, and an HDP coordinator restarted
in one package from the other's checkpoint resumes at the same step with
the same learned perfs, fleet clock and next plan.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import read_extras as jax_read_extras
from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.core import OverheadModel as JaxOverheadModel
from repro.data import GrainSpec as JaxGrainSpec
from repro.models import LayerSpec as JaxLayerSpec
from repro.models import Model as JaxModel
from repro.models import ModelConfig as JaxModelConfig
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train import HDPConfig as JaxHDPConfig
from repro.train import HDPTrainer as JaxHDPTrainer
from repro.train import Pod as JaxPod
from repro.train import init_train_state as jax_init_train_state
from repro_torch.checkpoint import AsyncCheckpointer, read_extras, restore
from repro_torch.core import OverheadModel
from repro_torch.data import GrainSpec
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import config as port_config
from repro_torch.optim import AdamWConfig
from repro_torch.train import HDPConfig, HDPTrainer, Pod, init_train_state
from repro_torch.tree import tree_flatten, tree_leaves

torch.set_num_threads(1)


def jax_cfg(dtype: str = "bfloat16") -> JaxModelConfig:
    return JaxModelConfig(
        name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        d_ff=64, vocab_size=64, head_dim=16,
        layer_pattern=(JaxLayerSpec("attn", "dense"),),
        param_dtype=dtype, compute_dtype=dtype, use_pallas=False,
        rope_theta=1e4,
    )


def port_cfg(jcfg: JaxModelConfig) -> ModelConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["layer_pattern"] = tuple(
        port_config.LayerSpec(**dataclasses.asdict(s))
        for s in jcfg.layer_pattern)
    fields["prefix_pattern"] = ()
    return ModelConfig(**fields)


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (torch or numpy/JAX), for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().reshape(-1)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _jax_state(seed: int = 0):
    """A JAX train state with bf16 params, non-zero f32 moments and a
    non-zero int32 step (so every leaf kind carries real bits)."""
    jstate = jax_init_train_state(JaxModel(jax_cfg()).init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    opt = jax.tree.map(
        lambda x: jax.numpy.asarray(rng.standard_normal(x.shape), x.dtype)
        if x.ndim else jax.numpy.asarray(7, x.dtype), jstate.opt)
    return dataclasses.replace(jstate, opt=opt)


def _port_like():
    model = Model(port_cfg(jax_cfg()), device="cpu")
    return init_train_state(model.init(1))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    jax_save(str(tmp_path), 3, jstate, extras={"clock": 1.5})
    state, step = restore(str(tmp_path), _port_like())
    assert step == 3
    assert state.params["embed"]["table"].dtype == torch.bfloat16
    assert state.opt["step"].dtype == torch.int32 and int(state.step) == 7
    got, want = tree_leaves(state), jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert read_extras(str(tmp_path)) == {"clock": 1.5}


def test_port_checkpoint_restores_in_jax(tmp_path):
    jstate = _jax_state(seed=2)
    state = init_train_state(params_from_numpy(
        jax.tree.map(np.asarray, jstate.params), "cpu"))
    opt = {"m": params_from_numpy(jax.tree.map(np.asarray, jstate.opt["m"]),
                                  "cpu"),
           "v": params_from_numpy(jax.tree.map(np.asarray, jstate.opt["v"]),
                                  "cpu"),
           "step": torch.tensor(7, dtype=torch.int32)}
    state = dataclasses.replace(state, opt=opt)
    ck = AsyncCheckpointer(str(tmp_path), keep_last=1)
    ck.save(2, state)
    ck.save(4, state, extras={"tracker": {"a": 1}, "clock": 2.0})
    ck.wait()
    restored, step = jax_restore(str(tmp_path), _jax_state(seed=9))
    assert step == 4
    for g, w in zip(jax.tree_util.tree_leaves(restored), tree_leaves(state),
                    strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert jax_read_extras(str(tmp_path)) == {"tracker": {"a": 1},
                                              "clock": 2.0}
    # keep_last=1 pruned step 2; tree.json is what the reference writes.
    with pytest.raises(FileNotFoundError, match="available steps: \\[4\\]"):
        restore(str(tmp_path), state, step=2)
    with open(tmp_path / "step_000000004" / "tree.json") as f:
        meta = json.load(f)
    jax_save(str(tmp_path / "jax"), 4, restored)
    with open(tmp_path / "jax" / "step_000000004" / "tree.json") as f:
        assert json.load(f) == meta
    assert meta["treedef"] == str(tree_flatten(state)[1])


def test_restore_validates_shapes_and_dtypes(tmp_path):
    jax_save(str(tmp_path), 1, _jax_state())
    like = _port_like()
    f32 = Model(port_cfg(jax_cfg("float32")), device="cpu")
    with pytest.raises(ValueError, match="leaf 0"):
        restore(str(tmp_path), init_train_state(f32.init(0)))
    with pytest.raises(ValueError, match="leaves"):
        restore(str(tmp_path), like.params)
    assert restore(str(tmp_path / "none"), like) == (None, None)


# ------------------------------------------------- HDP coordinator restarts
OPT_KW = dict(peak_lr=3e-3, min_lr=3e-4, warmup_steps=5, decay_steps=500,
              weight_decay=0.0)
PODS = [("fast", 3.0), ("slow", 1.0)]


def _jax_trainer(ckpt_dir):
    cfg = JaxHDPConfig(total_grains=8, grain_spec=JaxGrainSpec(1, 8, 64),
                       overhead=JaxOverheadModel(m=2.0), ckpt_dir=ckpt_dir,
                       ckpt_every=2)
    return JaxHDPTrainer(JaxModel(jax_cfg()), [JaxPod(n, p) for n, p in PODS],
                         cfg, opt_cfg=JaxAdamWConfig(**OPT_KW))


def _port_trainer(ckpt_dir):
    cfg = HDPConfig(total_grains=8, grain_spec=GrainSpec(1, 8, 64),
                    overhead=OverheadModel(m=2.0), ckpt_dir=ckpt_dir,
                    ckpt_every=2)
    return HDPTrainer(Model(port_cfg(jax_cfg()), device="cpu"),
                      [Pod(n, p) for n, p in PODS], cfg,
                      opt_cfg=AdamWConfig(**OPT_KW))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_hdp_restart_across_packages(tmp_path, first):
    """A coordinator killed after step 2 restarts in the other package: it
    resumes at step 2 from the same state, learned perfs and clock, and its
    first plan is the never-killed coordinator's."""
    d = str(tmp_path / "hdp")
    make_a, make_b = ((_jax_trainer, _port_trainer) if first == "jax"
                      else (_port_trainer, _jax_trainer))
    a = make_a(d)
    a.run(2)
    b = make_b(d)
    assert b.start_step == 2
    assert b.clock == a.clock
    assert b.tracker.perf_vector(b.clock) == a.tracker.perf_vector(a.clock)
    assert dataclasses.astuple(b.plan_preview()) == \
        dataclasses.astuple(a.plan_preview())
    for x, y in zip(jax.tree_util.tree_leaves(a.state) if first == "jax"
                    else tree_leaves(a.state),
                    tree_leaves(b.state) if first == "jax"
                    else jax.tree_util.tree_leaves(b.state), strict=True):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    rec = b.step(2)
    assert rec["plan"] == a.step(2)["plan"]
    assert np.isfinite(rec["loss"])


def test_tree_helpers_hold_no_leaf_past_their_call():
    """``tree_flatten``, ``tree_unflatten`` and ``tree_map`` build no
    reference cycle: with the garbage collector off, a leaf goes as soon as
    the caller drops it (a cycle would hold every flattened tensor of a
    model until the collector runs)."""
    import gc
    import weakref

    from repro_torch.models.transformer import init_stack
    from repro_torch.tree import tree_map, tree_unflatten

    cfg = port_cfg(jax_cfg())
    gen = torch.Generator()
    gen.manual_seed(0)
    gc.collect()
    gc.disable()
    try:
        stack = init_stack(gen, cfg)
        refs = [weakref.ref(t) for t in tree_leaves(stack)]
        leaves, treedef = tree_flatten(stack)
        again = tree_unflatten(treedef, leaves)
        doubled = tree_map(lambda t: t * 2, again)
        del stack, leaves, again, doubled
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
