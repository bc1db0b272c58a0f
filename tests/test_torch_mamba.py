"""Port parity: the mamba block and the mamba model against the JAX package
on bridged weights, at the reduced ``mamba2-2.7b`` on the CPU.

``mamba_train`` (output, conv tail, state) and ``mamba_decode`` (output and
the updated cache) take the reference's params through ``params_from_numpy``
and the same numpy inputs; ``Model.prefill`` and ``decode_step`` compare
logits and the stacked ``MambaCache``s; ``Model.loss`` and its gradients
are compared with ``jax.value_and_grad``.  Each runs on the plain grouped
SSD path (``use_pallas=False``) and on the kernel route
(``use_pallas=True``: the reference's Pallas kernel in interpret mode; the
port's K5 wrapper, which takes its plain version on the CPU).  Tolerance:
the reference's f32 rtol 5e-4 / atol 5e-5 (``tests/test_kernels.py:20-23``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import layers as jax_layers
from repro.models import mamba as jax_mamba
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.mamba_scan import mamba_scan as k5
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import config as port_config
from repro_torch.models import layers, mamba
from repro_torch.train import make_grain_grad_fn
from repro_torch.tree import tree_leaves

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

RTOL, ATOL = 5e-4, 5e-5
ARCH = "mamba2-2.7b"


def port_cfg(jcfg) -> ModelConfig:
    """The reference's config as the port's dataclass, field for field."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["layer_pattern"] = tuple(
        port_config.LayerSpec(**dataclasses.asdict(s))
        for s in jcfg.layer_pattern)
    fields["prefix_pattern"] = tuple(
        port_config.LayerSpec(**dataclasses.asdict(s))
        for s in jcfg.prefix_pattern)
    fields["ssm"] = port_config.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    if jcfg.moe is not None:
        fields["moe"] = port_config.MoEConfig(**dataclasses.asdict(jcfg.moe))
    return ModelConfig(**fields)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _block(use_pallas: bool):
    jcfg = jax_get_config(ARCH, reduced=True, use_pallas=use_pallas)
    jp = jax_mamba.init_mamba(jax.random.key(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, port_cfg(jcfg), jp, tp


def test_config_and_registry_match_reference():
    assert ARCH in ARCH_IDS
    for reduced in (False, True):
        assert get_config(ARCH, reduced=reduced) == \
            port_cfg(jax_get_config(ARCH, reduced=reduced))
    full = get_config(ARCH)
    s = full.ssm
    assert (full.n_layers, full.d_model, s.d_inner(full.d_model),
            s.n_heads(full.d_model), s.head_dim, s.d_state, s.n_groups,
            s.d_conv, s.chunk, full.padded_vocab, full.tie_embeddings) == \
        (64, 2560, 5120, 80, 64, 128, 1, 4, 256, 51200, True)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba_train_matches_jax(use_pallas):
    jcfg, tcfg, jp, tp = _block(use_pallas)
    x = np.random.default_rng(1).standard_normal((2, 40, jcfg.d_model)) \
        .astype(np.float32)
    jout, jcache = jax_mamba.mamba_train(jp, jcfg, jnp.asarray(x))
    out, cache = mamba.mamba_train(tp, tcfg, torch.as_tensor(x))
    _close(out, jout)
    assert tuple(cache.conv.shape) == jcache.conv.shape
    _close(cache.conv, jcache.conv)
    assert cache.state.dtype == torch.float32
    _close(cache.state, jcache.state)


@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_kernel_route_loss_and_gradients_match_jax_plain(arch):
    """The reduced model trained on the kernel route (``use_pallas=True``:
    K5's autograd function, whose CPU forward and backward are
    ``ssd_scan_plain`` and ``ssd_scan_bwd_plain``) against the reference's
    ``use_pallas=False`` (``jax.value_and_grad`` through its plain grouped
    scan), on bridged weights: ``Model.loss`` (and the MoE aux of Jamba)
    and every gradient leaf."""
    jcfg = jax_get_config(arch, reduced=True, use_pallas=False)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = Model(dataclasses.replace(port_cfg(jcfg), use_pallas=True),
               device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 41))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32),
             "loss_mask": (rng.random((2, 40)) > 0.2).astype(np.float32)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jparams, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    before = dict(k5.LAUNCHES)
    tloss, tmet = tm.loss(tparams, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    assert k5.LAUNCHES == before          # the CPU runs the plain versions
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(tmet["aux"].detach()), float(jmet["aux"]),
                               rtol=RTOL, atol=ATOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(tgrads) == len(jleaves)
    for t, j in zip(tgrads, jleaves, strict=True):
        assert tuple(t.shape) == j.shape
        _close(t, j)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_kernel_route_recomputes_the_scan_under_remat(policy, monkeypatch):
    """Under either remat policy a grain runs K5's forward twice a layer
    (the forward, then its recompute in the backward: the scan is no
    matrix product ``dots`` saves) and its backward once, as K4's; counted
    on the CPU through the plain versions the autograd function runs."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              use_pallas=True, remat_policy=policy)
    model = Model(cfg, device="cpu")
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("ssd_scan_plain", "fwd"),
                      ("ssd_scan_bwd_plain", "bwd")):
        def counted(*args, _fn=getattr(k5, name), _key=key, **kwargs):
            calls[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(k5, name, counted)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 41)))
    batch = {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int(),
             "loss_mask": torch.ones((2, 40))}
    make_grain_grad_fn(model, compile_steps=False)(model.init(0), batch)
    assert calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba_decode_matches_jax_and_updates_in_place(use_pallas):
    """Prefill 24 positions, then 4 one-token steps on the handed-over
    cache: the outputs and the final conv window and state match."""
    jcfg, tcfg, jp, tp = _block(use_pallas)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    _, jcache = jax_mamba.mamba_train(jp, jcfg, jnp.asarray(x))
    _, cache = mamba.mamba_train(tp, tcfg, torch.as_tensor(x))
    jdecode = jax.jit(lambda p, xt, c: jax_mamba.mamba_decode(p, jcfg, xt, c))
    for _ in range(4):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jout, jcache = jdecode(jp, jnp.asarray(xt), jcache)
        conv, state = cache.conv, cache.state
        out, cache = mamba.mamba_decode(tp, tcfg, torch.as_tensor(xt), cache)
        assert cache.conv is conv and cache.state is state
        _close(out, jout)
    _close(cache.conv, jcache.conv)
    _close(cache.state, jcache.state)


def test_gated_rms_norm_matches_jax():
    rng = np.random.default_rng(4)
    x, z = (rng.standard_normal((3, 5, 32)).astype(np.float32) for _ in "xz")
    w = rng.standard_normal(32).astype(np.float32)
    _close(layers.gated_rms_norm(*map(torch.as_tensor, (x, z, w)), 1e-6),
           jax_layers.gated_rms_norm(*map(jnp.asarray, (x, z, w)), 1e-6))


def test_init_dtypes_under_bf16_params_and_bridge():
    """``init_mamba`` keeps dt_bias, a_log and d_skip in f32 under a bf16
    ``param_dtype``, as the reference does; the bridge's ``dtype`` leaves
    those three as they come."""
    jcfg = jax_get_config(ARCH, reduced=True, param_dtype="bfloat16")
    jp = jax_mamba.init_mamba(jax.random.key(0), jcfg)
    tp = mamba.init_mamba(torch.Generator().manual_seed(0), port_cfg(jcfg))
    assert sorted(tp) == sorted(jp)
    for key, leaf in jp.items():
        assert str(tp[key].dtype) == f"torch.{leaf.dtype}", key
        assert tuple(tp[key].shape) == leaf.shape, key
    f32 = jax_mamba.init_mamba(jax.random.key(0),
                               jax_get_config(ARCH, reduced=True))
    bridged = params_from_numpy(jax.tree.map(np.asarray, f32), "cpu",
                                torch.bfloat16)
    for key, leaf in bridged.items():
        want = torch.float32 if key in mamba.F32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, key


def _models(use_pallas: bool):
    jcfg = jax_get_config(ARCH, reduced=True, use_pallas=use_pallas)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = Model(port_cfg(jcfg), device="cpu")
    return jm, jparams, tm, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _mamba_cache(caches):
    return caches["periods"]["pos0"]["self"]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_model_prefill_matches_jax(use_pallas):
    jm, jparams, tm, tparams = _models(use_pallas)
    L, bucket = 13, 32
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :L] = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, L)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                             last_pos=L - 1))(
        jparams, jnp.asarray(toks, jnp.int32))
    tl, tc = tm.prefill(tparams, {"tokens": torch.as_tensor(toks)},
                        last_pos=L - 1)
    _close(tl, jl)
    t, j = _mamba_cache(tc), _mamba_cache(jc)
    assert isinstance(t, mamba.MambaCache)
    for name in ("conv", "state"):
        assert tuple(getattr(t, name).shape) == getattr(j, name).shape
        _close(getattr(t, name), getattr(j, name))


def test_model_decode_step_matches_jax():
    """Three steps of a 2-slot batch from the zero cache: logits and the
    stacked cache, which the port updates in place."""
    jm, jparams, tm, tparams = _models(False)
    jcache, tcache = jm.init_cache(2, 32), tm.init_cache(2, 32)
    t = _mamba_cache(tcache)
    for name in ("conv", "state"):
        assert tuple(getattr(t, name).shape) == \
            getattr(_mamba_cache(jcache), name).shape
        assert getattr(t, name).dtype == torch.float32
    jdecode = jax.jit(jm.decode_step)
    rng = np.random.default_rng(2)
    pos = np.array([0, 3])
    for step in range(3):
        tok = rng.integers(0, jm.cfg.vocab_size, (2, 1))
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(pos + step, jnp.int32))
        tlog, out = tm.decode_step(tparams, tcache, torch.as_tensor(tok),
                                   torch.as_tensor(pos + step))
        assert out is tcache
        _close(tlog, jlog)
    for name in ("conv", "state"):
        _close(getattr(t, name), getattr(_mamba_cache(jcache), name))


def test_model_init_is_laid_out_like_reference():
    jm, jparams, tm, _ = _models(False)
    ours = tm.init(5)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = ours
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype) == f"torch.{leaf.dtype}", path


@pytest.mark.parametrize("use_pallas", [False, True])
def test_model_loss_and_gradients_match_jax_on_the_cpu(use_pallas):
    """A mamba model trains on the plain routes: the loss and autograd's
    gradients (through the grouped path, or through K5's plain version on
    the kernel route's CPU side) match ``jax.value_and_grad`` of the
    reference's plain path (loss rtol 1e-5, gradients rtol 2e-4 / atol
    1e-5, as ``test_torch_train.py``)."""
    jm, jparams, _, tparams = _models(False)
    tm = Model(port_cfg(dataclasses.replace(jm.cfg, use_pallas=use_pallas)),
               device="cpu")
    toks = np.random.default_rng(6).integers(0, jm.cfg.vocab_size, (2, 25))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "loss_mask": np.ones((2, 24), np.float32)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    leaves = jax.tree_util.tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = tm.loss(tparams, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for t, j in zip(leaves, jax.tree_util.tree_leaves(jgrads), strict=True):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=2e-4,
                                   atol=1e-5)
