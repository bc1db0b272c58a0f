"""Port parity: ``repro_torch.models.Model`` against the JAX ``Model`` on
bridged weights (``params_from_numpy``), in f32 on the CPU.

Configs: the ``tiny-disagg`` model of ``test_disagg.py``, the reduced
``qwen2-1.5b`` (QKV bias, tied embeddings), the reduced ``qwen2-1.5b``
with padded q heads (``tp_pad_heads``, as the full-width config pads 12 to
16), and the reduced ``codeqwen1.5-7b`` (MHA), ``qwen3-8b`` (``qk_norm``),
``granite-34b`` (one KV head, tied embeddings), ``qwen2-moe-a2.7b`` (MoE
with a shared expert) and ``jamba-v0.1-52b`` (mamba + attention + MoE in
one period) — with ``use_pallas`` True (the JAX Pallas kernel in interpret
mode; the port's kernel wrapper, which takes its plain version on the CPU)
and False.  ``prefill`` logits and caches, ``decode_step`` logits and
caches, and the loss with its gradients (against ``jax.grad`` with
``use_pallas=False``) match at the reference's f32 tolerance (rtol 5e-4 /
atol 5e-5); for ``qwen2-moe-a2.7b`` also under homogenized capacities that
drop tokens.
"""

import dataclasses
import functools

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
from repro_torch.models.moe import capacity_per_expert
from repro_torch.tree import tree_leaves

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

RTOL, ATOL = 5e-4, 5e-5


def tiny_cfg() -> JaxModelConfig:
    return JaxModelConfig(
        name="tiny-disagg", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        d_ff=64, vocab_size=64, head_dim=16,
        layer_pattern=(LayerSpec("attn", "dense"),),
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
        rope_theta=1e4,
    )


#: The archs this slice brings, at their reduced test sizes.
NEW_ARCHS = ("codeqwen1.5-7b", "qwen3-8b", "granite-34b", "qwen2-moe-a2.7b",
             "jamba-v0.1-52b")

CONFIGS = {
    "tiny-disagg": tiny_cfg,
    "qwen2-1.5b-reduced": lambda: jax_get_config("qwen2-1.5b", reduced=True),
    "qwen2-1.5b-reduced-padded": lambda: jax_get_config(
        "qwen2-1.5b", reduced=True, tp_pad_heads=8),
    **{f"{arch}-reduced": functools.partial(jax_get_config, arch,
                                            reduced=True)
       for arch in NEW_ARCHS},
}

#: Each sub-config class of the reference as the port's.
_SUB_CONFIGS = {"moe": port_config.MoEConfig, "ssm": port_config.SSMConfig,
                "mla": port_config.MLAConfig,
                "encoder": port_config.EncoderConfig}


def port_cfg(jcfg: JaxModelConfig) -> ModelConfig:
    """The same configuration as the port's dataclass (field for field,
    the layer specs and sub-configs as the port's classes)."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    for key in ("layer_pattern", "prefix_pattern"):
        fields[key] = tuple(port_config.LayerSpec(**dataclasses.asdict(s))
                            for s in getattr(jcfg, key))
    for key, cls in _SUB_CONFIGS.items():
        if fields[key] is not None:
            fields[key] = cls(**dataclasses.asdict(fields[key]))
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


def cache_leaves(tcaches, jcaches) -> list[tuple[np.ndarray, np.ndarray]]:
    """Every cache tensor of both packages, paired in the reference's leaf
    order (KV caches: k, v; mamba caches: conv window, state)."""
    t = [np.asarray(x) for x in tree_leaves(tcaches)]
    j = [np.asarray(x) for x in jax.tree_util.tree_leaves(jcaches)]
    assert len(t) == len(j) > 0
    return list(zip(t, j, strict=True))


def test_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JaxModelConfig)]
    full = get_config("qwen2-1.5b")
    assert (full.n_layers, full.d_model, full.n_q_heads, full.n_kv_heads,
            full.head_dim, full.padded_vocab) == (28, 1536, 16, 2, 128, 151936)
    assert full == port_cfg(jax_get_config("qwen2-1.5b"))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_match_reference_at_published_widths(arch):
    """Each new arch resolves, full width and reduced, to the reference's
    config field for field; the published widths as the configs state
    them."""
    for reduced in (False, True):
        assert get_config(arch, reduced=reduced) == port_cfg(
            jax_get_config(arch, reduced=reduced))
    c = get_config(arch)
    widths = (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
              c.d_ff, c.vocab_size)
    assert widths == {
        "codeqwen1.5-7b": (32, 4096, 32, 32, 128, 13440, 92416),
        "qwen3-8b": (36, 4096, 32, 8, 128, 12288, 151936),
        "granite-34b": (88, 6144, 48, 1, 128, 24576, 49152),
        "qwen2-moe-a2.7b": (24, 2048, 16, 16, 128, 5632, 151936),
        "jamba-v0.1-52b": (32, 4096, 32, 8, 128, 14336, 65536),
    }[arch]
    if arch == "qwen2-moe-a2.7b":
        m = c.moe
        assert (m.n_routed, m.top_k, m.d_expert, m.n_shared, m.d_shared,
                m.normalize_topk) == (60, 4, 1408, 1, 5632, False)
        assert c.qkv_bias and {s.mlp for s in c.layer_pattern} == {"moe"}
    if arch == "jamba-v0.1-52b":
        assert [(s.mixer, s.mlp) for s in c.layer_pattern] == [
            ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
            ("mamba", "moe"), ("attn", "dense"), ("mamba", "moe"),
            ("mamba", "dense"), ("mamba", "moe")]
        assert (c.moe.n_routed, c.moe.top_k, c.ssm.d_state,
                c.ssm.n_heads(c.d_model), c.ssm.head_dim, c.ssm.chunk) == \
            (16, 2, 16, 128, 64, 256)


PREFILL_CASES = [("tiny-disagg", True), ("tiny-disagg", False),
                 ("qwen2-1.5b-reduced", True), ("qwen2-1.5b-reduced", False),
                 ("qwen2-1.5b-reduced-padded", False)]
PREFILL_CASES += [(f"{arch}-reduced", False) for arch in NEW_ARCHS]
PREFILL_CASES += [("qwen3-8b-reduced", True), ("granite-34b-reduced", True),
                  ("jamba-v0.1-52b-reduced", True)]


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
    if tm.cfg.layer_pattern[0].mixer == "attn":
        for t, j in zip(kv_of(tc), kv_of(jc)):
            assert t.shape == j.shape == (tm.cfg.n_periods, 1, bucket,
                                          tm.cfg.n_kv_heads, tm.cfg.head_dim)
    for t, j in cache_leaves(tc, jc):
        assert t.shape == j.shape
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
    for t, j in cache_leaves(tcache, jcache):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def _loss_batch(vocab: int) -> dict:
    rng = np.random.default_rng(3)
    toks = rng.integers(0, vocab, (2, 13))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "loss_mask": (rng.random((2, 12)) > 0.2).astype(np.float32)}


def _loss_and_grads(name: str, capacities=None):
    """(port, reference) loss, aux and gradient leaves on the same batch,
    the reference's through ``jax.grad`` with ``use_pallas=False``."""
    jm, jparams, tm, tparams = build(name, False)
    batch = _loss_batch(jm.cfg.vocab_size)
    jcaps = None if capacities is None else jnp.asarray(capacities,
                                                        jnp.int32)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, jcaps), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, tmet = tm.loss(tparams, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, capacities)
    tgrads = torch.autograd.grad(tloss, leaves)
    return ((float(tloss.detach()), float(tmet["aux"].detach()), tgrads),
            (float(jloss), float(jmet["aux"]),
             jax.tree_util.tree_leaves(jgrads)))


@pytest.mark.parametrize("name", [f"{arch}-reduced" for arch in NEW_ARCHS])
def test_loss_and_gradients_match_jax(name):
    """The loss (cross-entropy plus the MoE aux terms, summed in layer
    order through each checkpointed period) and every gradient leaf, the
    MoE router's included, against ``jax.grad``."""
    (tl, ta, tg), (jl, ja, jg) = _loss_and_grads(name)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)
    assert (ta > 0) == ("moe" in name or "jamba" in name)
    assert len(tg) == len(jg)
    for t, j in zip(tg, jg, strict=True):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


def _dropping_capacities(cfg) -> np.ndarray:
    """Homogenized capacities for a 16-token prefill that drop tokens: the
    scope lengths of a budget at capacity factor 0.5 over unequal expert
    perfs."""
    m = dataclasses.replace(cfg.moe, capacity_factor=0.5)
    perfs = np.linspace(4.0, 0.5, m.n_routed)
    return capacity_per_expert(16, m, expert_perfs=perfs, round_to=1)


def test_moe_homogenized_capacities_that_drop_match_jax():
    """qwen2-moe with homogenized capacities that drop tokens: prefill
    logits and caches, and the loss with its gradients, against the
    reference given the same capacities; the drops move the logits."""
    name = "qwen2-moe-a2.7b-reduced"
    jm, jparams, tm, tparams = build(name, False)
    caps = _dropping_capacities(tm.cfg)
    toks = np.random.default_rng(4).integers(0, jm.cfg.vocab_size, (1, 16))
    jl, jc = jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c))(
        jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(caps, jnp.int32))
    tl, tc = tm.prefill(tparams, {"tokens": torch.as_tensor(toks)}, caps)
    free, _ = tm.prefill(tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    for t, j in cache_leaves(tc, jc):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    assert float((tl - free).abs().max()) > 1e-4
    (tloss, ta, tg), (jloss, ja, jg) = _loss_and_grads(name, caps)
    np.testing.assert_allclose([tloss, ta], [jloss, ja], rtol=RTOL,
                               atol=ATOL)
    for t, j in zip(tg, jg, strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


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
    # Training runs since slice 3, and under remat_policy='dots' since the
    # distribution-and-tooling slice: its forward is the default's.
    m = Model(cfg, device="cpu")
    toks = torch.zeros((1, 5), dtype=torch.int32)
    batch = {"tokens": toks, "targets": toks, "loss_mask": torch.ones((1, 5))}
    loss, metrics = m.loss(m.init(0), batch)
    assert torch.isfinite(loss) and float(metrics["tokens"]) == 5.0
    dots = Model(dataclasses.replace(cfg, remat_policy="dots"), device="cpu")
    assert torch.equal(dots.loss(dots.init(0), batch)[0], loss)
    # MLA layers run since the remaining-configs slice.
    mla = dataclasses.replace(cfg, layer_pattern=(
        port_config.LayerSpec("mla", "dense"),),
        mla=port_config.MLAConfig(q_lora_rank=16, kv_lora_rank=8,
                                  qk_nope_head_dim=8, qk_rope_head_dim=4,
                                  v_head_dim=8))
    m = Model(mla, device="cpu")
    loss, _ = m.loss(m.init(0), batch)
    assert torch.isfinite(loss)


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
