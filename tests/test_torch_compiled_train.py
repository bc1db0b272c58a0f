"""The training path's compiled steps (the counterpart of the reference's
``jax.jit`` on the grain gradient, on ``HDPTrainer``'s AdamW update and on
``train_single``'s step), f32 on the CPU.

On the CPU a compiled step runs eagerly over the static buffers a CUDA
graph would read and write (``serve/compiled.py``), so these tests hold the
training route to the graph's rules:

  (a) capture safety: the grain gradient (forward, remat recompute and
      backward), the update and ``train_single``'s step make none of the
      calls that, on CUDA, sync the host or copy from host memory while a
      graph is captured (``CaptureGuard``), on the reduced configs of the
      token-input decoders;
  (b) 3 ``HDPTrainer`` steps under a mid-step straggler that makes the
      combine buffer grains (a buffered grain's gradients are a graph's
      outputs, which the next grain overwrites): the compiled route's
      losses, grad norms and parameters equal the eager route's bit for
      bit, and both stay within the tolerance of the reference's trainer;
  (c) static and adaptive schedules bitwise equal on the compiled route;
  (d) two params trees alternated through one compiled grain function:
      each call gives the eager result, and a tree of other tensors drops
      the graph;
  (e) ``train_single`` compiled against eager and the reference, and its
      checkpoint restart on the compiled route;
  (f) the reduced Mamba models on K5's route (``use_pallas=True``: its
      autograd function, whose forward and backward run their plain
      versions on the CPU): the grain gradient capture-safe, and bit for
      bit the eager route's;
  (g) ``train_single`` on the batches the launcher feeds the embeds and
      enc-dec configs: the reduced Qwen2-VL on embeds with M-RoPE
      positions whose three streams differ (an image block), and the
      reduced SeamlessM4T at two target lengths (two graphs in one
      ``BatchSteps``), each on K4's route: guarded from each graph's
      second call, compiled bit for bit eager, both within the
      reference's tolerance.

The card's side (captured graphs, launch counts over replays) is in
``tests/test_torch_cuda.py``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import Cluster as JaxCluster
from repro.cluster import FleetSpec as JaxFleetSpec
from repro.cluster import TrainJob as JaxTrainJob
from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train import train_single as jax_train_single
from repro_torch.cluster import Cluster, FleetSpec, TrainJob
from repro_torch.configs import get_config
from repro_torch.data import GrainSpec
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig
from repro_torch.serve import compiled
from repro_torch.train import (
    HDPConfig,
    HDPTrainer,
    Pod,
    make_grain_grad_fn,
    train_single,
)
from repro_torch.train import loop as train_loop
from repro_torch.tree import tree_leaves
from test_torch_compiled import ARCHS, CaptureGuard
from test_torch_mrope import vl_positions
from test_torch_train import (
    FLEET,
    GRAD_TOL,
    LOSS_RTOL,
    OPT_KW,
    SCENARIO,
    BridgedModel,
    _loss_batch,
    port_cfg,
    tiny_cfg,
)

torch.set_num_threads(1)

STEPS = 3


def _batch(vocab: int, seed: int) -> dict:
    return {k: torch.from_numpy(v) for k, v in _loss_batch(vocab, seed).items()}


@contextlib.contextmanager
def _guarded_from_second_call():
    """Every ``CompiledStep`` runs its first call unguarded (the warm-up a
    capture follows) and later ones under ``CaptureGuard``; yields the
    names of the steps that ran guarded."""
    guarded = []
    run = compiled.CompiledStep._run

    def checked(step):
        if step.calls == 1:
            return run(step)
        guarded.append(step.name)
        with CaptureGuard():
            return run(step)

    compiled.CompiledStep._run = checked
    try:
        yield guarded
    finally:
        compiled.CompiledStep._run = run


@contextlib.contextmanager
def _recorded_combines():
    """The ``_PrefixCombine`` of each training step, in step order."""
    seen = []

    class Recorded(train_loop._PrefixCombine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_loop, "_PrefixCombine", Recorded)
        yield seen


# ------------------------------------------------------------- (a) capture
@pytest.mark.parametrize("arch", ARCHS)
def test_training_steps_are_capture_safe(arch):
    """(a) Two HDP steps of 3 grains and two ``train_single`` steps, each
    compiled step guarded from its second call on: the grain gradient from
    the second grain, the update from the second step."""
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, device="cpu")
    spec = GrainSpec(grain_size=2, seq_len=8, vocab_size=cfg.vocab_size)
    tr = HDPTrainer(model, [Pod("a", 1.0), Pod("b", 1.0)],
                    HDPConfig(total_grains=3, grain_spec=spec),
                    opt_cfg=AdamWConfig(**OPT_KW))
    batch = _batch(cfg.vocab_size, 2)
    with _guarded_from_second_call() as guarded:
        tr.run(2)
        _, hist = train_single(model, 2, lambda s: batch,
                               opt_cfg=AdamWConfig(**OPT_KW), log_every=1)
    assert guarded.count("grain_grad[2x8,2x8,2x8]") == 5
    assert guarded.count("update") == 1
    assert guarded.count("train_single[2x16,2x16,2x16]") == 1
    assert all(np.isfinite(r["loss"]) for r in tr.history)
    assert all(np.isfinite(h["loss"]) for h in hist)


# ------------------------------------------------ (b, c) the HDP trainer
def _port_train(compile_steps: bool, adaptive: bool = True):
    with _recorded_combines() as combines:
        rep = Cluster(FleetSpec.parse(FLEET, prefix="pod"), adaptive=adaptive,
                      device="cpu").train(
            TrainJob(BridgedModel(tiny_cfg()), steps=STEPS, grains=8,
                     seq_len=8, vocab_size=64, opt=AdamWConfig(**OPT_KW),
                     compile_steps=compile_steps),
            scenario=SCENARIO)
    return rep, combines


@pytest.fixture(scope="module")
def straggler_runs():
    """The reference's trainer and the port's on both routes (and the
    compiled route under the static schedule), 3 steps under the mid-step
    halving."""
    jrep = JaxCluster(JaxFleetSpec.parse(FLEET, prefix="pod")).train(
        JaxTrainJob(JaxModel(tiny_cfg()), steps=STEPS, grains=8, seq_len=8,
                    vocab_size=64, opt=JaxAdamWConfig(**OPT_KW)),
        scenario=SCENARIO)
    return {"reference": jrep, "compiled": _port_train(True),
            "eager": _port_train(False),
            "static": _port_train(True, adaptive=False)}


def _route(rep) -> dict:
    return {"loss": [p.metrics["loss"] for p in rep.phases],
            "grad_norm": [p.metrics["grad_norm"] for p in rep.phases],
            "params": tree_leaves(rep.artifact.state.params)}


def test_hdp_compiled_equals_eager_with_buffered_grains(straggler_runs):
    """(b) Compiled and eager: losses, grad norms and every parameter bit
    for bit, with grains buffered by the combine on both routes; the
    compiled route ran its grain and update steps, the eager one none."""
    (fast, fast_c), (slow, slow_c) = (straggler_runs["compiled"],
                                      straggler_runs["eager"])
    assert len(fast_c) == len(slow_c) == STEPS
    assert [c.buffered for c in fast_c] == [c.buffered for c in slow_c]
    assert sum(c.buffered for c in fast_c) > 0
    a, b = _route(fast), _route(slow)
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert all(torch.equal(x, y)
               for x, y in zip(a["params"], b["params"], strict=True))
    trainer = fast.artifact
    assert trainer.compile_steps and trainer._update is not None
    assert [s.calls for s in trainer._grad_fn.steps] == [8 * STEPS]
    assert trainer._update.calls == STEPS
    assert not slow.artifact.compile_steps
    assert slow.artifact._update is None and not slow.artifact._grad_fn.steps


@pytest.mark.parametrize("route", ["compiled", "eager"])
def test_hdp_routes_match_reference(straggler_runs, route):
    """(b) Each route within the reference trainer's tolerance (that of
    ``test_torch_train.test_hdp_trainer_matches_reference``)."""
    jrep, (rep, _) = straggler_runs["reference"], straggler_runs[route]
    got = _route(rep)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(
            got[key], [p.metrics[key] for p in jrep.phases], rtol=1e-4,
            err_msg=key)
    assert [p.shares for p in rep.phases] == [p.shares for p in jrep.phases]
    want = jax.tree_util.tree_leaves(jrep.artifact.state.params)
    for g, w in zip(got["params"], want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_hdp_static_and_adaptive_bitwise_on_compiled_route(straggler_runs):
    """(c) The static plan and the adaptive one, both compiled: other
    schedules, the same bits."""
    (ad, _), (st, _) = straggler_runs["compiled"], straggler_runs["static"]
    assert st.artifact.compile_steps and ad.artifact.compile_steps
    assert [p.shares for p in ad.phases] != [p.shares for p in st.phases] \
        or [p.n_migrated for p in ad.phases] != \
        [p.n_migrated for p in st.phases]
    a, b = _route(ad), _route(st)
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert all(torch.equal(x, y)
               for x, y in zip(a["params"], b["params"], strict=True))


def test_buffered_grain_keeps_its_own_gradients():
    """The combine's aliasing: a grain that completes before an earlier one
    is buffered as a copy, so a later write into the gradients it was
    handed (a replay's) does not reach the sum."""
    grads = {"w": torch.tensor([1.0, 2.0])}
    combine = train_loop._PrefixCombine(False, None)
    combine.add(1, 0.5, 2.0, grads)
    grads["w"].fill_(100.0)
    combine.add(0, 0.25, 1.0, {"w": torch.tensor([3.0, 5.0])})
    assert combine.buffered == 1 and not combine.pending
    assert torch.equal(combine.grads(2)["w"],
                       torch.tensor([5.0 / 3.0, 9.0 / 3.0]))


# ------------------------------------------------ (d) the grain function
def test_alternated_params_trees_give_the_eager_result():
    """(d) Two params trees through one compiled grain function, in turns
    and over two batches: each call equals the eager route's, and a tree
    of other tensors drops the graph and warms up again; the same tensors,
    updated in place, keep it."""
    model = Model(port_cfg(tiny_cfg()), device="cpu")
    trees = (model.init(0), model.init(1))
    batches = (_batch(64, 1), _batch(64, 2))
    fast = make_grain_grad_fn(model)
    slow = make_grain_grad_fn(model, compile_steps=False)
    calls = []
    for which in (0, 0, 1, 1, 0, 1, 1):
        for batch in batches:
            (loss, met), grads = fast(trees[which], batch)
            (want, wmet), wgrads = slow(trees[which], batch)
            assert torch.equal(loss, want)
            assert all(torch.equal(met[k], wmet[k]) for k in wmet)
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(grads), tree_leaves(wgrads), strict=True))
            (step,) = fast.steps
            calls.append(step.calls)
    assert calls == [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 1, 2, 3, 4]
    for leaf in tree_leaves(trees[1]):
        leaf.mul_(0.5)
    (loss, _), _ = fast(trees[1], batches[0])
    assert fast.steps[0].calls == 5
    assert torch.equal(loss, slow(trees[1], batches[0])[0][0])


# ------------------------------------------------ (e) train_single
def test_train_single_compiled_equals_eager_and_reference():
    """(e) Three steps: the compiled route's history and parameters bit for
    bit the eager route's, both within the reference's tolerance."""
    jcfg = tiny_cfg()
    batch = _loss_batch(jcfg.vocab_size)
    jstate, jhist = jax_train_single(
        JaxModel(tiny_cfg()), STEPS, lambda s: {k: jnp.asarray(v)
                                       for k, v in batch.items()},
        opt_cfg=JaxAdamWConfig(**OPT_KW), log_every=1)
    model = BridgedModel(jcfg)
    runs = {}
    for compile_steps in (True, False):
        tb = _batch(jcfg.vocab_size, 1)
        runs[compile_steps] = train_single(
            model, STEPS, lambda s: tb, opt_cfg=AdamWConfig(**OPT_KW),
            log_every=1, compile_steps=compile_steps)
    (fast, fhist), (slow, shist) = runs[True], runs[False]
    assert fhist == shist and len(fhist) == STEPS
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(fast), tree_leaves(slow), strict=True))
    for got, want in zip(fhist, jhist, strict=True):
        for key in ("loss", "tokens", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                       err_msg=key)
    for g, w in zip(tree_leaves(fast.params),
                    jax.tree_util.tree_leaves(jstate.params), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_train_single_restart_exact_on_compiled_route(tmp_path):
    """(e) ``test_torch_train``'s restart test on the compiled route: 2
    steps with a checkpoint, a restart to 3 equals a straight compiled run
    to 3 and an eager one, bitwise."""
    model = BridgedModel(tiny_cfg())
    batch = _batch(64, 1)
    opt = AdamWConfig(**OPT_KW)
    d = str(tmp_path / "ck")
    train_single(model, 2, lambda s: batch, opt_cfg=opt, ckpt_dir=d,
                 ckpt_every=2, log_every=1, compile_steps=True)
    resumed, hist = train_single(model, 3, lambda s: batch, opt_cfg=opt,
                                 ckpt_dir=d, ckpt_every=2, log_every=1,
                                 compile_steps=True)
    straight, _ = train_single(model, 3, lambda s: batch, opt_cfg=opt,
                               log_every=1, compile_steps=True)
    eager, _ = train_single(model, 3, lambda s: batch, opt_cfg=opt,
                            log_every=1, compile_steps=False)
    assert [h["step"] for h in hist] == [2]
    for a, b, c in zip(tree_leaves(resumed), tree_leaves(straight),
                       tree_leaves(eager), strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_new_state_drops_the_trainer_graphs():
    """A new ``TrainState`` (a restore) drops the grain and update steps
    and the gradient buffers; the trainer then trains as a fresh one."""
    model = Model(port_cfg(tiny_cfg()), device="cpu")
    spec = GrainSpec(grain_size=1, seq_len=8, vocab_size=64)

    def trainer():
        return HDPTrainer(model, [Pod("a", 1.0), Pod("b", 1.0)],
                          HDPConfig(total_grains=4, grain_spec=spec),
                          opt_cfg=AdamWConfig(**OPT_KW))

    tr = trainer()
    tr.run(2)
    assert tr._grad_fn.steps and tr._update is not None
    tr.state = trainer().state
    assert not tr._grad_fn.steps and tr._update is None and tr._grads is None
    fresh = trainer()
    tr.step(0)
    fresh.step(0)
    assert tr.history[-1]["loss"] == fresh.history[-1]["loss"]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tr.state.params), tree_leaves(fresh.state.params),
        strict=True))


# ------------------------------------------- (f) Mamba on the kernel route
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_kernel_route_grain_is_capture_safe_and_bitwise_eager(arch):
    """(f) The reduced model on K5's route, three grains of 40 tokens (the
    reduced chunk is 16: two full chunks and a short one): the compiled
    grain gradient guarded from its second call, each call's loss, metrics
    and gradients equal to the eager route's bit for bit, the graph kept
    over the three."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), use_pallas=True)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    fast = make_grain_grad_fn(model)
    slow = make_grain_grad_fn(model, compile_steps=False)
    rng = np.random.default_rng(7)
    with _guarded_from_second_call() as guarded:
        for _ in range(3):
            toks = rng.integers(0, cfg.vocab_size, (2, 41))
            batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
                     "targets": torch.from_numpy(toks[:, 1:].astype(np.int32)),
                     "loss_mask": torch.from_numpy(
                         (rng.random((2, 40)) > 0.2).astype(np.float32))}
            (loss, met), grads = fast(params, batch)
            (want, wmet), wgrads = slow(params, batch)
            assert torch.equal(loss, want)
            assert all(torch.equal(met[k], wmet[k]) for k in wmet)
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(grads), tree_leaves(wgrads), strict=True))
    assert len(guarded) == 2
    assert [s.calls for s in fast.steps] == [3]


# ------------------------------------ (g) the embeds and enc-dec batches
#: The configs ``train_single`` trains on ``configs/shapes.py``'s batch
#: kinds other than tokens (kept apart from ``ARCHS``, which the engine's
#: tests also read: ``DecodeEngine`` refuses both).
BATCH_ARCHS = ("qwen2-vl-7b", "seamless-m4t-medium")


def _arch_batches(cfg) -> list[dict]:
    """The numpy batches of (g), one a step: Qwen2-VL's embeds over two
    rows of text, an image block and text (the (B, 3, S) streams differ),
    three steps of one batch; SeamlessM4T's source frames with 12 and then
    5 target tokens, in turn over four steps."""
    rng = np.random.default_rng(11)

    def loss_fields(b, s):
        return {"targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                    np.int32),
                "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}

    if cfg.input_mode == "embeds" and not cfg.is_enc_dec:
        pos = np.stack([vl_positions(2, 3, 5), vl_positions(4, 2, 8)])
        assert (pos[:, 0] != pos[:, 1]).any() and \
            (pos[:, 1] != pos[:, 2]).any()
        s = pos.shape[-1]
        one = {"embeds": rng.standard_normal((2, s, cfg.d_model)).astype(
                   np.float32),
               "positions": pos, **loss_fields(2, s)}
        return [one] * STEPS
    shapes = []
    for tgt in (12, 5):
        shapes.append({
            "src_embeds": (rng.standard_normal((2, 10, cfg.d_model)) * 0.5)
            .astype(np.float32),
            "tgt_tokens": rng.integers(0, cfg.vocab_size, (2, tgt)).astype(
                np.int32),
            **loss_fields(2, tgt)})
    return [shapes[i % 2] for i in range(2 * 2)]


@pytest.fixture(scope="module", params=BATCH_ARCHS)
def arch_runs(request):
    """(g) The reference's ``train_single`` and the port's on both routes
    (the compiled one guarded from each graph's second call), from the
    reference's initial weights, on one list of numpy batches."""
    jcfg = jax_get_config(request.param, reduced=True)
    batches = _arch_batches(jcfg)
    n = len(batches)
    jstate, jhist = jax_train_single(
        JaxModel(jcfg), n, lambda s: {k: jnp.asarray(v)
                                      for k, v in batches[s].items()},
        opt_cfg=JaxAdamWConfig(**OPT_KW), log_every=1)
    model = BridgedModel(jcfg)
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    runs = {}
    with _guarded_from_second_call() as guarded:
        runs["compiled"] = train_single(
            model, n, lambda s: tb[s], opt_cfg=AdamWConfig(**OPT_KW),
            log_every=1, compile_steps=True)
    runs["eager"] = train_single(model, n, lambda s: tb[s],
                                 opt_cfg=AdamWConfig(**OPT_KW), log_every=1,
                                 compile_steps=False)
    return {"arch": request.param, "reference": (jstate, jhist),
            "guarded": guarded, "batches": batches, **runs}


def test_padded_vocab_logits_are_capture_safe():
    """(g) The logits of a vocabulary padded to a multiple (SeamlessM4T's
    250 to 256 reduced, 256206 to 258048 whole) mask the pad columns with
    -1e30 by ``fill_``: no host tensor inside a captured step, and the
    reference's values."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers

    cfg = get_config("seamless-m4t-medium", reduced=True)
    assert cfg.padded_vocab > cfg.vocab_size
    rng = np.random.default_rng(5)
    table = rng.standard_normal((cfg.padded_vocab, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    params, xt = {"table": torch.from_numpy(table)}, torch.from_numpy(x)
    with CaptureGuard():
        got = layers.lm_logits(params, xt, cfg)
    want = jlayers.lm_logits({"table": jnp.asarray(table)}, jnp.asarray(x),
                             jax_get_config("seamless-m4t-medium",
                                            reduced=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (got[..., cfg.vocab_size:] < -1e29).all()


def test_arch_train_single_is_capture_safe(arch_runs):
    """(g) Each batch shape's graph ran its second and later calls under
    ``CaptureGuard``: one graph for Qwen2-VL, two for SeamlessM4T."""
    names = arch_runs["guarded"]
    shapes = {tuple(b[k].shape for k in sorted(b))
              for b in arch_runs["batches"]}
    assert len(shapes) == (2 if arch_runs["arch"].startswith("seamless")
                           else 1)
    assert len(set(names)) == len(shapes)
    assert len(names) == len(arch_runs["batches"]) - len(shapes)


def test_arch_train_single_compiled_equals_eager(arch_runs):
    """(g) The compiled route's history and every state leaf (parameters
    and moments) bit for bit the eager route's."""
    (fast, fhist), (slow, shist) = arch_runs["compiled"], arch_runs["eager"]
    assert fhist == shist and len(fhist) == len(arch_runs["batches"])
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(fast), tree_leaves(slow), strict=True))


@pytest.mark.parametrize("route", ["compiled", "eager"])
def test_arch_train_single_matches_reference(arch_runs, route):
    """(g) Each route within the reference's ``train_single`` tolerance
    (that of (e)): every step's loss, tokens, grad norm and learning rate,
    and the final parameters."""
    jstate, jhist = arch_runs["reference"]
    state, hist = arch_runs[route]
    for got, want in zip(hist, jhist, strict=True):
        for key in ("loss", "tokens", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                       err_msg=key)
    for g, w in zip(tree_leaves(state.params),
                    jax.tree_util.tree_leaves(jstate.params), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
