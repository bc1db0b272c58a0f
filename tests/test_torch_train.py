"""Port parity: the training path (slice 3) against the JAX package.

On the CPU, with the same numpy inputs made from seeds and the same weights
through the params bridge:

  - ``Model.loss`` and its gradients (reduced Qwen2 with padded q heads and
    the ``tiny_cfg`` of ``tests/test_train_loop.py``; ``ce_chunk`` 0 and
    > 0; remat on): loss rtol 1e-5, gradients rtol 2e-4 / atol 1e-5 (the
    reference's combine tolerance, ``tests/test_train_loop.py``), leaves in
    the reference's order;
  - ``adamw_update`` and ``lr_at`` per leaf within rtol 1e-6; the int8
    payload of the error-feedback compression equal;
  - ``SyntheticSource``, ``MemmapSource`` and ``batch_from_grains`` bitwise;
  - ``Cluster.train`` over fleet 4:3:2:1 with a mid-step halving, 2 steps:
    the trainer's shares, migrations, steals and sim-clock step times equal,
    the params within rtol 2e-4 / atol 1e-5, the ``RunReport`` fields equal;
  - in the port alone: adaptive and static bitwise identical, the weighted
    combine equal to one worker's update, the wall-clock train smoke test
    of ``tests/test_wallclock.py``, and the launcher's HDP mode.

The reference's results are computed once per module (its jits run once).
"""

import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import Cluster as JaxCluster
from repro.cluster import FleetSpec as JaxFleetSpec
from repro.cluster import TrainJob as JaxTrainJob
from repro.configs import get_config as jax_get_config
from repro.data import GrainSpec as JaxGrainSpec
from repro.data import MemmapSource as JaxMemmapSource
from repro.data import SyntheticSource as JaxSyntheticSource
from repro.data import batch_from_grains as jax_batch_from_grains
from repro.models import LayerSpec as JaxLayerSpec
from repro.models import Model as JaxModel
from repro.models import ModelConfig as JaxModelConfig
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import lr_at as jax_lr_at
from repro.optim.grad_compress import compress as jax_compress
from repro.optim.grad_compress import ef_compress_tree as jax_ef_compress
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.cluster import Cluster, FleetSpec, TrainJob
from repro_torch.data import GrainSpec, MemmapSource, SyntheticSource, batch_from_grains
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import config as port_config
from repro_torch.models.transformer import apply_stack
from repro_torch.optim import AdamWConfig, adamw_update, lr_at
from repro_torch.optim.grad_compress import compress, ef_compress_tree
from repro_torch.train import (
    HDPConfig,
    HDPTrainer,
    Pod,
    init_train_state,
    make_grain_grad_fn,
    make_train_step,
    train_single,
)
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
OPT_KW = dict(peak_lr=3e-3, min_lr=3e-4, warmup_steps=5, decay_steps=500,
              weight_decay=0.0)


def tiny_cfg(**kw) -> JaxModelConfig:
    base = dict(
        name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        d_ff=64, vocab_size=64, head_dim=16,
        layer_pattern=(JaxLayerSpec("attn", "dense"),),
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
        rope_theta=1e4,
    )
    base.update(kw)
    return JaxModelConfig(**base)


def port_cfg(jcfg: JaxModelConfig, **kw) -> ModelConfig:
    """The same configuration as the port's dataclass (field for field)."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["layer_pattern"] = tuple(
        port_config.LayerSpec(**dataclasses.asdict(s))
        for s in jcfg.layer_pattern)
    fields["prefix_pattern"] = ()
    fields.update(kw)
    return ModelConfig(**fields)


def jax_params(jcfg: JaxModelConfig, seed: int = 0):
    return jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.key(seed)))


class BridgedModel(Model):
    """A port ``Model`` whose ``init(seed)`` returns the reference's initial
    params for that seed (the two packages draw different random numbers),
    so trainers built by the facade start from the same weights."""

    def __init__(self, jcfg: JaxModelConfig):
        super().__init__(port_cfg(jcfg, use_pallas=True), device="cpu")
        self.jcfg = jcfg

    def init(self, seed: int = 0) -> dict:
        return params_from_numpy(jax_params(self.jcfg, seed), "cpu")


# ------------------------------------------------------------------ model loss
MODEL_CASES = {
    "tiny": lambda: tiny_cfg(),
    "tiny-ce_chunk3": lambda: tiny_cfg(ce_chunk=3),
    "qwen2-1.5b-reduced-padded": lambda: jax_get_config(
        "qwen2-1.5b", reduced=True, tp_pad_heads=8),
}


def _loss_batch(vocab: int, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, 17))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "loss_mask": (rng.random((2, 16)) > 0.2).astype(np.float32)}


@pytest.fixture(scope="module")
def loss_reference():
    out = {}
    for name, make in MODEL_CASES.items():
        jcfg = make()
        jm = JaxModel(jcfg)
        params = jm.init(jax.random.key(0))
        batch = _loss_batch(jcfg.vocab_size)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b), has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        out[name] = (jcfg, jax.tree.map(np.asarray, params), batch,
                     float(loss), [np.asarray(g)
                                   for g in jax.tree_util.tree_leaves(grads)])
    return out


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_loss_and_gradients_match_reference(loss_reference, name):
    jcfg, params, batch, want_loss, want_grads = loss_reference[name]
    model = Model(port_cfg(jcfg, use_pallas=True), device="cpu")
    (loss, metrics), grads = make_grain_grad_fn(model)(
        params_from_numpy(params, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert float(metrics["tokens"]) == float(batch["loss_mask"].sum())
    got = tree_leaves(grads)
    assert len(got) == len(want_grads)
    for g, w in zip(got, want_grads, strict=True):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_remat_changes_no_bit_and_dots_policy_raises():
    jcfg = MODEL_CASES["qwen2-1.5b-reduced-padded"]()
    cfg = port_cfg(jcfg, use_pallas=True)
    params = params_from_numpy(jax_params(jcfg), "cpu")
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    pos = torch.arange(12)[None].expand(2, 12)
    outs = []
    for remat in (True, False):
        x = x0.clone().requires_grad_(True)
        y, caches, _ = apply_stack(params["stack"], cfg, x, mode="train",
                                   positions=pos, remat=remat)
        assert caches is None
        outs.append((y, torch.autograd.grad(y.square().sum(), x)[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    # remat_policy="dots" runs (since the distribution-and-tooling slice):
    # it keeps the matrix products' outputs, and changes no bit either.
    x = x0.clone().requires_grad_(True)
    y, _, _ = apply_stack(params["stack"], dataclasses.replace(
        cfg, remat_policy="dots"), x, mode="train", positions=pos)
    assert torch.equal(y, outs[0][0])
    assert torch.equal(torch.autograd.grad(y.square().sum(), x)[0],
                       outs[0][1])


def test_microbatched_train_step_matches_reference():
    """``make_train_step(n_micro=2)``: token-weighted f32 accumulation over
    two microbatches, then AdamW, against the reference's step."""
    jcfg = tiny_cfg()
    batch = _loss_batch(jcfg.vocab_size)
    jm = JaxModel(jcfg)
    jstate = jax_init_train_state(jm.init(jax.random.key(0)))
    jnew, jmet = jax.jit(jax_make_train_step(
        jm, JaxAdamWConfig(**OPT_KW), n_micro=2))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    model = BridgedModel(jcfg)
    state, met = make_train_step(model, AdamWConfig(**OPT_KW), n_micro=2)(
        init_train_state(model.init(0)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "tokens", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    for g, w in zip(tree_leaves(state.params),
                    jax.tree_util.tree_leaves(jnew.params), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_train_single_checkpoint_restart_exact(tmp_path):
    """``tests/test_train_loop.py``'s restart test on the port: 2 steps with
    a checkpoint, a restart to 3 equals a straight run to 3, bitwise."""
    model = BridgedModel(tiny_cfg())
    batch = {k: torch.from_numpy(v) for k, v in _loss_batch(64).items()}
    opt = AdamWConfig(**OPT_KW)
    d = str(tmp_path / "ck")
    train_single(model, 2, lambda s: batch, opt_cfg=opt, ckpt_dir=d,
                 ckpt_every=2, log_every=1)
    resumed, hist = train_single(model, 3, lambda s: batch, opt_cfg=opt,
                                 ckpt_dir=d, ckpt_every=2, log_every=1)
    straight, _ = train_single(model, 3, lambda s: batch, opt_cfg=opt,
                               log_every=1)
    assert [h["step"] for h in hist] == [2]
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight), strict=True):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ optimizer
def _opt_inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4, 5), "b": (7,), "c": {"d": (4, 6), "e": (2,)}}

    def tree(scale, positive=False):
        def leaf(shape):
            x = rng.standard_normal(shape) * scale
            return np.abs(x).astype(np.float32) if positive \
                else x.astype(np.float32)
        return {"a": leaf(shapes["a"]), "b": leaf(shapes["b"]),
                "c": {"d": leaf(shapes["c"]["d"]), "e": leaf(shapes["c"]["e"])}}

    return tree(1.0), tree(0.3), tree(0.01), tree(1e-4, positive=True)


@pytest.mark.parametrize("step0,gscale", [(0, 1.0), (7, 1.0), (300, 0.01)])
def test_adamw_update_matches_reference(step0, gscale):
    params, grads, m, v = _opt_inputs()
    grads = jax.tree.map(lambda g: g * np.float32(gscale), grads)
    jcfg = JaxAdamWConfig(warmup_steps=5, decay_steps=500)
    jp, jo, js = jax_adamw_update(
        jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.asarray(step0, jnp.int32)},
        jax.tree.map(jnp.asarray, params), jcfg)
    tp, to, ts = adamw_update(
        params_from_numpy(grads, "cpu"),
        {"m": params_from_numpy(m, "cpu"), "v": params_from_numpy(v, "cpu"),
         "step": torch.tensor(step0, dtype=torch.int32)},
        params_from_numpy(params, "cpu"),
        AdamWConfig(warmup_steps=5, decay_steps=500))
    assert int(to["step"]) == int(jo["step"]) == step0 + 1
    assert to["step"].dtype == torch.int32
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(ts[key]), float(js[key]), rtol=1e-6)
    for want, got in ((jp, tp), (jo["m"], to["m"]), (jo["v"], to["v"])):
        for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got),
                        strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [7, 16])
def test_adamw_update_in_slices_keeps_its_bits(monkeypatch, size, dtype,
                                               in_place):
    """Leaves larger than ``adamw.SLICE`` elements are updated a slice at
    a time: at a slice of 7 or 16 elements (every leaf above but one
    sliced, at offsets of any alignment) the new parameters and moments
    are the whole-leaf update's bit for bit, and in place they land in
    the given tensors."""
    from repro_torch.optim import adamw as adamw_mod

    params, grads, m, v = _opt_inputs()
    cfg = AdamWConfig(warmup_steps=5, decay_steps=500)

    def run(slice_size):
        monkeypatch.setattr(adamw_mod, "SLICE", slice_size)
        p = tree_map(lambda t: t.to(dtype), params_from_numpy(params, "cpu"))
        opt = {"m": params_from_numpy(m, "cpu"),
               "v": params_from_numpy(v, "cpu"),
               "step": torch.tensor(3, dtype=torch.int32)}
        given = tree_leaves(p)
        new_p, new_opt, stats = adamw_update(
            tree_map(lambda t: t.to(dtype), params_from_numpy(grads, "cpu")),
            opt, p, cfg, in_place=in_place)
        assert all((a is b) is in_place for a, b in zip(
            tree_leaves(new_p), given, strict=True))
        return (tree_leaves(new_p) + tree_leaves(new_opt["m"])
                + tree_leaves(new_opt["v"])), stats

    whole, wstats = run(1 << 26)
    sliced, sstats = run(size)
    assert all(torch.equal(wstats[k], sstats[k]) for k in wstats)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(whole, sliced, strict=True))


def test_lr_schedule_matches_reference():
    jcfg = JaxAdamWConfig(warmup_steps=10, decay_steps=200)
    steps = np.arange(0, 260, 3, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jax_lr_at(jcfg, s))(steps))
    got = lr_at(AdamWConfig(warmup_steps=10, decay_steps=200),
                torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_error_feedback_compression_matches_reference():
    _, grads, residuals, _ = _opt_inputs(seed=4)
    jdeq, jres = jax_ef_compress(jax.tree.map(jnp.asarray, grads),
                                 jax.tree.map(jnp.asarray, residuals))
    deq, res = ef_compress_tree(params_from_numpy(grads, "cpu"),
                                params_from_numpy(residuals, "cpu"))
    for want, got in ((jdeq, deq), (jres, res)):
        for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got),
                        strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-9)
    for g, r in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(residuals), strict=True):
        corrected = g + r
        jq, js = jax_compress(jnp.asarray(corrected))
        q, s = compress(torch.from_numpy(corrected))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)


# ----------------------------------------------------------------------- data
def test_grains_and_batches_are_bitwise_equal(tmp_path):
    spec, jspec = GrainSpec(2, 8, 64), JaxGrainSpec(2, 8, 64)
    src, jsrc = SyntheticSource(spec, seed=5), JaxSyntheticSource(jspec, seed=5)
    for step, gid in [(0, 0), (0, 7), (3, 2), (11, 5)]:
        np.testing.assert_array_equal(src.grain(step, gid),
                                      jsrc.grain(step, gid))
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(6).integers(
        0, 64, 500).astype(np.int32))
    msrc, jmsrc = MemmapSource(str(path), spec), JaxMemmapSource(str(path),
                                                                  jspec)
    for s, js in ((src, jsrc), (msrc, jmsrc)):
        got = batch_from_grains(s, 2, [1, 4], spec, pad_to_grains=3)
        want = jax_batch_from_grains(js, 2, [1, 4], jspec, pad_to_grains=3)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == {"tokens": torch.int32,
                                      "targets": torch.int32,
                                      "loss_mask": torch.float32}[key]
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


# ---------------------------------------------------- trainer and facade (HDP)
FLEET = "4:3:2:1"
SCENARIO = "halve:pod0@1:25%"


def _train_job(model, job_cls, opt_cls):
    return job_cls(model, steps=2, grains=8, seq_len=8, vocab_size=64,
                   opt=opt_cls(**OPT_KW))


@pytest.fixture(scope="module")
def reference_run():
    rep = JaxCluster(JaxFleetSpec.parse(FLEET, prefix="pod")).train(
        _train_job(JaxModel(tiny_cfg()), JaxTrainJob, JaxAdamWConfig),
        scenario=SCENARIO)
    params = [np.asarray(p) for p in
              jax.tree_util.tree_leaves(rep.artifact.state.params)]
    return rep, params


@functools.lru_cache(maxsize=2)
def _port_run(adaptive: bool):
    rep = Cluster(FleetSpec.parse(FLEET, prefix="pod"), adaptive=adaptive,
                  device="cpu").train(
        _train_job(BridgedModel(tiny_cfg()), TrainJob, AdamWConfig),
        scenario=SCENARIO)
    return rep, tree_leaves(rep.artifact.state.params)


def test_hdp_trainer_matches_reference(reference_run):
    (jrep, jparams), (rep, params) = reference_run, _port_run(True)
    jhist, hist = jrep.artifact.history, rep.artifact.history
    assert len(hist) == len(jhist) == 2
    for got, want in zip(hist, jhist, strict=True):
        for key in ("step", "plan", "n_migrated", "n_steals", "step_time",
                    "quality", "tokens", "worker_busy", "worker_finish"):
            assert got[key] == want[key], key
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
    assert sum(r["n_migrated"] for r in hist) > 0
    for g, w in zip(params, jparams, strict=True):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_cluster_train_report_matches_reference(reference_run):
    (jrep, _), (rep, _) = reference_run, _port_run(True)
    for field in ("kind", "fleet", "scenario", "work_done", "sim_time_s",
                  "throughput", "predicted_speedup", "measured_speedup",
                  "backend", "telemetry"):
        assert getattr(rep, field) == getattr(jrep, field), field
    assert {w: dataclasses.asdict(t) for w, t in rep.worker_timelines.items()} \
        == {w: dataclasses.asdict(t) for w, t in jrep.worker_timelines.items()}
    assert len(rep.phases) == len(jrep.phases)
    for got, want in zip(rep.phases, jrep.phases, strict=True):
        for field in ("index", "label", "work", "sim_time_s", "quality",
                      "n_migrated", "shares"):
            assert getattr(got, field) == getattr(want, field), field
        assert set(got.metrics) == set(want.metrics)
        for key, val in want.metrics.items():
            np.testing.assert_allclose(got.metrics[key], val, rtol=1e-4,
                                       err_msg=key)
    assert set(rep.metrics) == set(jrep.metrics)
    for key in ("start_step", "overhead_slope"):
        assert rep.metrics[key] == jrep.metrics[key]
    for key in ("first_loss", "final_loss"):
        np.testing.assert_allclose(rep.metrics[key], jrep.metrics[key],
                                   rtol=1e-4)


def test_hdp_adaptive_and_static_are_bitwise_identical():
    (ra, pa), (rs, ps) = _port_run(True), _port_run(False)
    assert [p.metrics["loss"] for p in ra.phases] == \
        [p.metrics["loss"] for p in rs.phases]
    assert [p.metrics["grad_norm"] for p in ra.phases] == \
        [p.metrics["grad_norm"] for p in rs.phases]
    assert ra.phases[1].shares != rs.phases[1].shares or \
        ra.phases[1].n_migrated != rs.phases[1].n_migrated
    assert all(torch.equal(a, b) for a, b in zip(pa, ps, strict=True))


def test_hdp_weighted_combine_matches_single_worker():
    """Equal perfs, no compression: HDP over 2 pods equals one worker's
    update on the concatenated batch (as ``tests/test_train_loop.py``)."""
    model = Model(port_cfg(tiny_cfg()), device="cpu")
    spec = GrainSpec(grain_size=1, seq_len=8, vocab_size=64)
    opt = AdamWConfig(**OPT_KW)
    cfg = HDPConfig(total_grains=4, grain_spec=spec)
    tr = HDPTrainer(model, [Pod("a", 1.0), Pod("b", 1.0)], cfg, opt_cfg=opt)
    tr.step(0)
    batch = batch_from_grains(SyntheticSource(spec, seed=cfg.seed), 0,
                              [0, 1, 2, 3], spec)
    state = init_train_state(model.init(cfg.seed))
    _, grads = make_grain_grad_fn(model)(state.params, batch)
    new_params, _, _ = adamw_update(grads, state.opt, state.params, opt)
    for a, b in zip(tree_leaves(tr.state.params), tree_leaves(new_params),
                    strict=True):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_wallclock_train_smoke():
    """``tests/test_wallclock.py``'s train smoke test on the port."""
    cfg = port_cfg(tiny_cfg(n_layers=1, d_model=16, d_ff=32, vocab_size=32,
                            head_dim=8))
    rep = Cluster("2:1", backend="wallclock", device="cpu").train(
        TrainJob(Model(cfg, device="cpu"), steps=2, grains=4, seq_len=8))
    assert rep.backend.startswith("wallclock")
    assert np.isfinite(rep.phases[-1].metrics["loss"])


def test_train_launcher_hdp_mode_ends_with_summary():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--mode", "hdp", "--steps", "2", "--seq", "8", "--grains", "4",
         "--scenario", "halve:pod0@1:25%"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("[train] fleet=pod0=4,pod1=3,pod2=2,pod3=1 "
                           "scenario=halve:pod0@1:25% 2 phase(s)"), last
