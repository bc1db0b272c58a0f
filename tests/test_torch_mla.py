"""Port parity of Multi-head Latent Attention (``models/mla.py``) and the
reduced ``deepseek-v2-236b`` (an MLA dense prefix layer, then MLA + MoE
periods) against the JAX package, on the same numpy inputs and bridged
weights, in f32 on the CPU, at the reference's f32 tolerance (rtol 5e-4 /
atol 5e-5).

MLA runs no kernel in either package (plain einsums), so ``use_pallas``
does not reach it.  Covered: ``mla_train`` chunked and unchunked, causal
and not; ``mla_prefill``'s output and latent cache; the absorbed
``mla_decode`` against the reference and against the decompressed
(``mla_train``) last-token output; the model's prefill, decode, loss and
every gradient against ``jax.grad``; and an ``MLACache`` handed off through
``DecodeEngine.prefill`` + ``insert`` (the dense prefix layer's cache
through lane axis 0), which gives ``submit``'s tokens and the reference
engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import mla as jmla
from repro.serve import DecodeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import Model, mla, params_from_numpy
from repro_torch.models.mamba import MambaCache
from repro_torch.serve import DecodeEngine, Request
from repro_torch.serve.engine import _put
from repro_torch.tree import tree_leaves
from test_torch_model import cache_leaves, port_cfg

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

RTOL, ATOL = 5e-4, 5e-5
ARCH = "deepseek-v2-236b"


def _cfgs(**overrides):
    jcfg = jax_get_config(ARCH, reduced=True, **overrides)
    return jcfg, port_cfg(jcfg)


def _layer(jcfg, seed=0):
    jp = jmla.init_mla(jax.random.key(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _pos(b, s):
    return np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)


def test_config_matches_reference_at_published_widths():
    for reduced in (False, True):
        assert get_config(ARCH, reduced=reduced) == port_cfg(
            jax_get_config(ARCH, reduced=reduced))
    c = get_config(ARCH)
    m = c.mla
    assert (c.n_layers, c.d_model, c.n_heads, c.vocab_size) == \
        (60, 5120, 128, 102400)
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
            m.qk_rope_head_dim, m.v_head_dim) == (1536, 512, 128, 64, 128)
    assert (c.moe.n_routed, c.moe.top_k, c.moe.d_expert, c.moe.n_shared,
            c.moe.routed_scaling) == (160, 6, 1536, 2, 16.0)
    assert [(s.mixer, s.mlp) for s in c.prefix_pattern] == [("mla", "dense")]
    assert [(s.mixer, s.mlp) for s in c.layer_pattern] == [("mla", "moe")]


@pytest.mark.parametrize("chunk,s,causal", [(1024, 11, True), (4, 11, True),
                                            (4, 11, False), (3, 12, True)])
def test_mla_train_matches_jax(chunk, s, causal):
    """Unchunked (one chunk of all queries) and chunked over queries, with
    a ragged last chunk (11 = 4 + 4 + 3) and an even split."""
    jcfg, cfg = _cfgs(attn_chunk=chunk)
    jp, tp = _layer(jcfg)
    x, pos = _x(cfg, 2, s), _pos(2, s)
    want = jmla.mla_train(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                          causal=causal)
    got = mla.mla_train(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_mla_prefill_output_and_cache_match_jax():
    jcfg, cfg = _cfgs(attn_chunk=4)
    jp, tp = _layer(jcfg)
    x, pos = _x(cfg, 2, 9), _pos(2, 9)
    jout, jc = jmla.mla_prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    tout, tc = mla.mla_prefill(tp, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    assert tc.c_kv.shape == (2, 9, cfg.mla.kv_lora_rank)
    assert tc.k_rope.shape == (2, 9, cfg.mla.qk_rope_head_dim)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,per_slot", [("dus", False), ("onehot", False),
                                           ("dus", True)])
def test_mla_decode_matches_jax(mode, per_slot):
    """Three absorbed decode steps on a 2-lane cache, a scalar position
    (slice or one-hot write) or per-slot positions; outputs and the
    written cache against the reference's."""
    jcfg, cfg = _cfgs(cache_update=mode)
    jp, tp = _layer(jcfg)
    jc = jmla.init_mla_cache(jcfg, 2, 8)
    tc = mla.init_mla_cache(cfg, 2, 8, "cpu")
    base = np.array([1, 4]) if per_slot else np.array(2)
    for step in range(3):
        x = _x(cfg, 2, 1, seed=10 + step)
        pos = base + step
        jout, jc = jmla.mla_decode(jp, jcfg, jnp.asarray(x), jc,
                                   jnp.asarray(pos, jnp.int32))
        tout, tc = mla.mla_decode(tp, cfg, torch.from_numpy(x), tc,
                                  torch.as_tensor(pos))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=RTOL, atol=ATOL)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   rtol=RTOL, atol=ATOL)


def test_absorbed_decode_matches_decompressed_last_token():
    """Prefill t tokens, then decode token t at position t in the absorbed
    form: the output equals the decompressed form's last-token output over
    t + 1 tokens, in both packages."""
    jcfg, cfg = _cfgs()
    jp, tp = _layer(jcfg)
    t = 7
    x, pos = _x(cfg, 1, t + 1), _pos(1, t + 1)
    full = mla.mla_train(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    _, pre = mla.mla_prefill(tp, cfg, torch.from_numpy(x[:, :t]),
                             torch.from_numpy(pos[:, :t]))
    cache = mla.init_mla_cache(cfg, 1, 16, "cpu")
    _put(cache, pre, 0, 0)
    out, _ = mla.mla_decode(tp, cfg, torch.from_numpy(x[:, t:]), cache,
                            torch.tensor(t))
    np.testing.assert_allclose(out.numpy(), full[:, t:].numpy(), rtol=RTOL,
                               atol=ATOL)
    jfull = jmla.mla_train(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    _, jpre = jmla.mla_prefill(jp, jcfg, jnp.asarray(x[:, :t]),
                               jnp.asarray(pos[:, :t]))
    jcache = jmla.init_mla_cache(jcfg, 1, 16)
    jcache = jmla.MLACache(
        c_kv=jcache.c_kv.at[:, :t].set(jpre.c_kv),
        k_rope=jcache.k_rope.at[:, :t].set(jpre.k_rope))
    jout, _ = jmla.mla_decode(jp, jcfg, jnp.asarray(x[:, t:]), jcache,
                              jnp.int32(t))
    np.testing.assert_allclose(np.asarray(jout), np.asarray(jfull)[:, t:],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)


def test_put_writes_mla_sequence_axis_and_mamba_whole():
    """``_put`` writes an ``MLACache`` handoff over positions [0, bucket)
    of its lane (the stacked layout's batch axis 1, a prefix layer's 0)
    and leaves the rest; a ``MambaCache`` goes whole."""
    full = mla.MLACache(c_kv=torch.full((2, 3, 16, 4), -1.0),
                        k_rope=torch.full((2, 3, 16, 2), -1.0))
    part = mla.MLACache(c_kv=torch.ones((2, 1, 8, 4)),
                        k_rope=torch.ones((2, 1, 8, 2)) * 2)
    _put(full, part, 1, 2)
    assert torch.all(full.c_kv[:, 2, :8] == 1)
    assert torch.all(full.k_rope[:, 2, :8] == 2)
    assert torch.all(full.c_kv[:, 2, 8:] == -1)
    assert torch.all(full.c_kv[:, :2] == -1)
    prefix = mla.MLACache(c_kv=torch.zeros((3, 16, 4)),
                          k_rope=torch.zeros((3, 16, 2)))
    _put(prefix, mla.MLACache(c_kv=torch.ones((1, 4, 4)),
                              k_rope=torch.ones((1, 4, 2))), 0, 1)
    assert float(prefix.c_kv.sum()) == 16 and torch.all(prefix.c_kv[1, :4] == 1)
    whole = MambaCache(conv=torch.zeros((2, 3, 3, 5)),
                       state=torch.zeros((2, 3, 4, 6, 7)))
    _put(whole, MambaCache(conv=torch.ones((2, 1, 3, 5)),
                           state=torch.ones((2, 1, 4, 6, 7))), 1, 0)
    assert torch.all(whole.conv[:, 0] == 1) and torch.all(whole.state[:, 0] == 1)
    assert torch.all(whole.conv[:, 1:] == 0)


# ------------------------------------------------------------- the model
def _build(**overrides):
    jcfg = jax_get_config(ARCH, reduced=True, **overrides)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = Model(port_cfg(jcfg), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, tm, tparams


def test_model_prefill_matches_jax():
    """Prefill logits and every cache (the prefix layer's ``MLACache``,
    the stacked periods') of a right-padded bucket."""
    jm, jparams, tm, tparams = _build()
    L, bucket = 13, 16
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :L] = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, L)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                             last_pos=L - 1))(
        jparams, jnp.asarray(toks, jnp.int32))
    tl, tc = tm.prefill(tparams, {"tokens": torch.as_tensor(toks)},
                        last_pos=L - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    assert isinstance(tc["prefix"][0]["self"], mla.MLACache)
    assert tc["periods"]["pos0"]["self"].c_kv.shape == (
        tm.cfg.n_periods, 1, bucket, tm.cfg.mla.kv_lora_rank)
    for t, j in cache_leaves(tc, jc):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_model_decode_matches_jax():
    jm, jparams, tm, tparams = _build()
    jdecode = jax.jit(jm.decode_step)
    rng = np.random.default_rng(2)
    jcache, tcache = jm.init_cache(2, 32), tm.init_cache(2, 32)
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


def test_model_loss_and_gradients_match_jax():
    """The loss (cross-entropy plus the MoE aux terms) and every gradient
    leaf, the prefix layer's included, against ``jax.grad``."""
    jm, jparams, tm, tparams = _build()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jm.cfg.vocab_size, (2, 13))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32),
             "loss_mask": (rng.random((2, 12)) > 0.2).astype(np.float32)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, tmet = tm.loss(tparams, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose([float(tloss.detach()), float(tmet["aux"])],
                               [float(jloss), float(jmet["aux"])],
                               rtol=RTOL, atol=ATOL)
    assert float(tmet["aux"]) > 0
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(tgrads) == len(jleaves)
    for t, j in zip(tgrads, jleaves, strict=True):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


def test_mla_handoff_through_insert_gives_submit_tokens():
    """An ``MLACache`` handoff of a shorter bucket (prompts of 5 and 11
    tokens: buckets 8 and 16, max_seq 32) through ``prefill`` + ``insert``
    gives the tokens of ``submit`` (the prompt teacher-forced through
    decode steps), and the reference engine's tokens on both paths.  The
    MoE capacity factor is 4.0, as the reduced ``qwen2-moe-a2.7b`` has it:
    at 1.25 a bucketed prefill may drop assignments that decode does not
    (ROADMAP section 3), which is a different property."""
    jm, jparams, tm, tparams = _build(
        moe=dataclasses.replace(jax_get_config(ARCH, reduced=True).moe,
                                capacity_factor=4.0))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 255, n)] for n in (5, 11)]
    out = {}
    for pkg, engine_cls, req_cls, model, params in (
            ("port", DecodeEngine, Request, tm, tparams),
            ("ref", JaxEngine, JaxRequest, jm, jparams)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        fed = engine_cls(model, params, max_batch=2, max_seq=32, **kw)
        a = [req_cls(i, list(p), 6) for i, p in enumerate(prompts)]
        for r in a:
            fed.submit(r)
        fed.run_until_drained()
        dec = engine_cls(model, params, max_batch=2, max_seq=32, **kw)
        pre = engine_cls(model, params, max_batch=2, max_seq=32, **kw)
        b = [req_cls(i, list(p), 6) for i, p in enumerate(prompts)]
        for r in b:
            dec.insert(pre.prefill(r))
        dec.run_until_drained()
        out[pkg] = ([r.out_tokens for r in a], [r.out_tokens for r in b])
    assert out["port"][0] == out["port"][1]
    assert out["port"] == out["ref"]
