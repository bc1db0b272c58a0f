"""Port parity: ``repro_torch.models.Model`` against the JAX ``Model`` on
bridged weights (``params_from_numpy``), in f32 on the CPU.

Configs: the ``tiny-disagg`` model of ``test_disagg.py``, the reduced
``qwen2-1.5b`` (QKV bias, tied embeddings), and the reduced ``qwen2-1.5b``
with padded q heads (``tp_pad_heads``, as the full-width config pads 12 to
16) — each with ``use_pallas`` True (the JAX Pallas kernel in interpret
mode; the port's kernel wrapper, which takes its plain version on the CPU)
and False.  ``prefill`` logits and caches and ``decode_step`` logits match
at the reference's f32 tolerance (rtol 5e-4 / atol 5e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import LayerSpec
from repro.models import Model as JaxModel
from repro.models import ModelConfig as JaxModelConfig
from repro_torch.configs import get_config
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import config as port_config

RTOL, ATOL = 5e-4, 5e-5


def tiny_cfg() -> JaxModelConfig:
    return JaxModelConfig(
        name="tiny-disagg", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        d_ff=64, vocab_size=64, head_dim=16,
        layer_pattern=(LayerSpec("attn", "dense"),),
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
        rope_theta=1e4,
    )


CONFIGS = {
    "tiny-disagg": tiny_cfg,
    "qwen2-1.5b-reduced": lambda: jax_get_config("qwen2-1.5b", reduced=True),
    "qwen2-1.5b-reduced-padded": lambda: jax_get_config(
        "qwen2-1.5b", reduced=True, tp_pad_heads=8),
}


def port_cfg(jcfg: JaxModelConfig) -> ModelConfig:
    """The same configuration as the port's dataclass (field for field)."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["layer_pattern"] = tuple(
        port_config.LayerSpec(**dataclasses.asdict(s))
        for s in jcfg.layer_pattern)
    fields["prefix_pattern"] = ()
    return ModelConfig(**fields)


def build(name: str, use_pallas: bool):
    jcfg = dataclasses.replace(CONFIGS[name](), use_pallas=use_pallas)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = Model(port_cfg(jcfg), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, tm, tparams


def kv_of(caches):
    c = caches["periods"]["pos0"]["self"]
    return np.asarray(c.k), np.asarray(c.v)


def test_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JaxModelConfig)]
    full = get_config("qwen2-1.5b")
    assert (full.n_layers, full.d_model, full.n_q_heads, full.n_kv_heads,
            full.head_dim, full.padded_vocab) == (28, 1536, 16, 2, 128, 151936)
    assert full == port_cfg(jax_get_config("qwen2-1.5b"))


PREFILL_CASES = [("tiny-disagg", True), ("tiny-disagg", False),
                 ("qwen2-1.5b-reduced", True), ("qwen2-1.5b-reduced", False),
                 ("qwen2-1.5b-reduced-padded", False)]


@pytest.mark.parametrize("name,use_pallas", PREFILL_CASES)
def test_prefill_matches_jax(name, use_pallas):
    jm, jparams, tm, tparams = build(name, use_pallas)
    rng = np.random.default_rng(1)
    L, bucket = 13, 16
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :L] = rng.integers(0, jm.cfg.vocab_size, L)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, last_pos=L - 1))(
        jparams, jnp.asarray(toks, jnp.int32))
    tl, tc = tm.prefill(tparams, {"tokens": torch.as_tensor(toks)},
                        last_pos=L - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    for t, j in zip(kv_of(tc), kv_of(jc)):
        assert t.shape == j.shape == (tm.cfg.n_periods, 1, bucket,
                                      tm.cfg.n_kv_heads, tm.cfg.head_dim)
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_step_matches_jax(name):
    """Three decode steps of a 2-slot batch with per-slot positions (decode
    attention has no kernel, so ``use_pallas`` does not reach it)."""
    jm, jparams, tm, tparams = build(name, False)
    jdecode = jax.jit(jm.decode_step)
    rng = np.random.default_rng(2)
    jcache = jm.init_cache(2, 32)
    tcache = tm.init_cache(2, 32)
    pos = np.array([0, 3])
    for step in range(3):
        tok = rng.integers(0, jm.cfg.vocab_size, (2, 1))
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(pos + step, jnp.int32))
        tlog, tcache = tm.decode_step(tparams, tcache, torch.as_tensor(tok),
                                      torch.as_tensor(pos + step))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=RTOL, atol=ATOL)
    for t, j in zip(kv_of(tcache), kv_of(jcache)):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["dus", "onehot"])
def test_decode_cache_write_modes_match_jax(mode):
    """A scalar position takes the slice write under ``dus`` and the
    one-hot write under ``onehot``; both leave the reference's values."""
    jcfg = dataclasses.replace(tiny_cfg(), cache_update=mode)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(2))
    tm = Model(port_cfg(jcfg), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jcache, tcache = jm.init_cache(2, 16), tm.init_cache(2, 16)
    jdecode = jax.jit(jm.decode_step)
    for p in range(3):
        tok = np.array([[p + 1], [p + 7]])
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok, jnp.int32),
                               jnp.int32(p))
        tlog, tcache = tm.decode_step(tparams, tcache, torch.as_tensor(tok), p)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=RTOL, atol=ATOL)
    for t, j in zip(kv_of(tcache), kv_of(jcache)):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_kernel_branch_returns_cache_dtype_plain_branch_uncast():
    """With the kernel the prefill cache comes back in the cache dtype; the
    plain branch returns K/V uncast — both as in the reference."""
    base = dataclasses.replace(tiny_cfg(), cache_dtype="bfloat16")
    toks = {"tokens": torch.arange(16)[None] % 64}
    for use_pallas, want in ((True, torch.bfloat16), (False, torch.float32)):
        m = Model(port_cfg(dataclasses.replace(base, use_pallas=use_pallas)),
                  device="cpu")
        _, caches = m.prefill(m.init(0), toks)
        assert caches["periods"]["pos0"]["self"].k.dtype == want


def test_device_policy_and_later_slices():
    cfg = port_cfg(tiny_cfg())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Model(cfg)
    with pytest.raises(NotImplementedError, match="training slice"):
        Model(cfg, device="cpu").loss(None, None)
    moe = dataclasses.replace(cfg, layer_pattern=(
        port_config.LayerSpec("attn", "moe"),),
        moe=port_config.MoEConfig(n_routed=4, top_k=2, d_expert=8))
    with pytest.raises(NotImplementedError, match="MoE"):
        Model(moe, device="cpu")


def test_port_init_is_seeded_and_laid_out_like_reference():
    jm, jparams, tm, _ = build("qwen2-1.5b-reduced", False)
    a, b = tm.init(5), tm.init(5)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        node_a, node_b = a, b
        for key in path:
            node_a, node_b = node_a[key.key], node_b[key.key]
        assert tuple(node_a.shape) == leaf.shape, path
        assert torch.equal(node_a, node_b), path
