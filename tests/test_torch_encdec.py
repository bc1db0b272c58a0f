"""Port parity of the encoder-decoder path (``Model.encode``, the decoder's
cross-attention, LayerNorm) and the reduced ``seamless-m4t-medium``
against the JAX package, on the same numpy inputs and bridged weights, in
f32 on the CPU, at the reference's f32 tolerance (rtol 5e-4 / atol 5e-5).

K4's route: with ``use_pallas=True`` the encoder's non-causal attention and
the training cross-attention (Sq != Skv) go through the port's K4 wrapper,
which takes its plain version on the CPU, against the reference's Pallas
kernel in interpret mode (its gradients against ``jax.grad`` of the
reference's plain route: the reference's Pallas call has no JVP, ROADMAP
section 3).

The cross-pad property of the reference, pinned here in both packages:
``apply_layer`` passes no ``cross_len`` to the cross-attention decode, so a
cross cache from ``init_cache(..., cross_seq=N)`` longer than the encoder
memory attends to its zero rows too (score 0, not -inf).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.models import Model, attention, layers, params_from_numpy
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves
from test_torch_model import cache_leaves, port_cfg

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

RTOL, ATOL = 5e-4, 5e-5
ARCH = "seamless-m4t-medium"
SRC, TGT = 10, 7


def _cfgs(**overrides):
    jcfg = jax_get_config(ARCH, reduced=True, **overrides)
    return jcfg, port_cfg(jcfg)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _attn(jcfg, seed=0):
    jp = jattn.init_attention(jax.random.key(seed), jcfg)
    # Non-zero biases, so the cross projections' bias terms are checked.
    jp = {k: (v + 0.1 * jax.random.normal(jax.random.key(seed + 1), v.shape)
              if k.startswith("b") else v) for k, v in jp.items()}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_config_matches_reference_at_published_widths():
    for reduced in (False, True):
        assert get_config(ARCH, reduced=reduced) == port_cfg(
            jax_get_config(ARCH, reduced=reduced))
    c = get_config(ARCH)
    assert (c.n_layers, c.encoder.n_layers, c.d_model, c.n_heads,
            c.n_kv_heads, c.head_dim, c.d_ff, c.vocab_size) == \
        (12, 12, 1024, 16, 16, 64, 4096, 256206)
    assert c.use_layernorm and c.is_enc_dec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """LayerNorm (mean and biased variance in f32, then scale and bias),
    the norm of every seamless layer, at the f32 and bf16 tolerances."""
    tol = (RTOL, ATOL) if dtype == "float32" else (2e-2, 2e-2)
    x, w, b = _np((2, 5, 64), 0, 3.0) + 1.0, _np((64,), 1), _np((64,), 2)
    jx = jnp.asarray(x).astype(dtype)
    want = jlayers.layer_norm(jx, jnp.asarray(w), jnp.asarray(b), 1e-6)
    tx = torch.from_numpy(x).to(layers.dtype_of(dtype))
    got = layers.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b),
                            1e-6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol[0], atol=tol[1])
    _, cfg = _cfgs()
    p = {"scale": torch.from_numpy(w), "bias": torch.from_numpy(b)}
    assert torch.equal(layers.apply_norm(cfg, p, tx), got)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_cross_attention_train_matches_jax(use_pallas):
    """Non-causal attention of 7 queries over 10 memory rows (Sq != Skv),
    no rope, K4's route or the plain one, against the reference's."""
    jcfg, cfg = _cfgs(use_pallas=use_pallas)
    jp, tp = _attn(jcfg)
    x, mem = _np((2, TGT, cfg.d_model), 3), _np((2, SRC, cfg.d_model), 4)
    qpos = np.broadcast_to(np.arange(TGT)[None], (2, TGT)).astype(np.int32)
    mpos = np.broadcast_to(np.arange(SRC)[None], (2, SRC)).astype(np.int32)
    want = jattn.attention_train(jp, jcfg, jnp.asarray(x), jnp.asarray(qpos),
                                 causal=False, xkv=jnp.asarray(mem),
                                 kv_positions=jnp.asarray(mpos), rope=False)
    got = attention.attention_train(tp, cfg, torch.from_numpy(x),
                                    torch.from_numpy(qpos), causal=False,
                                    xkv=torch.from_numpy(mem),
                                    kv_positions=torch.from_numpy(mpos),
                                    rope=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_kv_matches_jax(qk_norm):
    """The memory's K/V, projected once; with ``qk_norm`` the keys take
    ``k_norm`` (the queries' ``q_norm`` comes in the decode)."""
    jcfg, cfg = _cfgs(qk_norm=qk_norm, qkv_bias=True)
    jp, tp = _attn(jcfg)
    if qk_norm:
        jp = dict(jp, k_norm=jp["k_norm"] * 1.5)
        tp = dict(tp, k_norm=tp["k_norm"] * 1.5)
    mem = _np((2, SRC, cfg.d_model), 4)
    want = jtf.cross_kv(jp, jcfg, jnp.asarray(mem))
    got = tf.cross_kv(tp, cfg, torch.from_numpy(mem))
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cross_len", [None, 6])
def test_cross_attention_decode_matches_jax(cross_len):
    """``attention_decode(cross=True)``: no cache write, the valid mask
    ``arange < cross_len`` (the whole cache when None); one query and a
    prefill's 7."""
    jcfg, cfg = _cfgs(qk_norm=True, qkv_bias=True)
    jp, tp = _attn(jcfg)
    mem = _np((2, SRC, cfg.d_model), 4)
    jc = jtf.cross_kv(jp, jcfg, jnp.asarray(mem))
    tc = tf.cross_kv(tp, cfg, torch.from_numpy(mem))
    before = tc.k.clone()
    for sq in (1, TGT):
        x = _np((2, sq, cfg.d_model), 5 + sq)
        want, _ = jattn.attention_decode(jp, jcfg, jnp.asarray(x), jc, None,
                                         cross=True, cross_len=cross_len)
        got, out_c = attention.attention_decode(
            tp, cfg, torch.from_numpy(x), tc, None, cross=True,
            cross_len=cross_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        assert out_c is tc and torch.equal(tc.k, before)


# ------------------------------------------------------------- the model
def _build(use_pallas=False, **overrides):
    jcfg = jax_get_config(ARCH, reduced=True, use_pallas=use_pallas,
                          **overrides)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = Model(port_cfg(jcfg), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, tm, tparams


def _src(cfg, b=1, s=SRC, seed=1):
    return _np((b, s, cfg.d_model), seed, 0.5)


def test_params_are_laid_out_like_reference():
    """The bridge carries ``enc_stack``, ``enc_final_norm`` and each
    decoder layer's ``norm_cross``/``cross`` as they are: the port's own
    init has the reference's leaf paths and shapes."""
    jm, jparams, tm, _ = _build()
    mine = tm.init(0)
    assert {"enc_stack", "enc_final_norm"} <= set(mine)
    assert {"norm_cross", "cross"} <= set(mine["stack"]["periods"]["pos0"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path


@pytest.mark.parametrize("use_pallas", [True, False])
def test_encode_matches_jax(use_pallas):
    """The encoder memory: non-causal layers (K4's route on ``use_pallas``)
    then the encoder's final LayerNorm."""
    jm, jparams, tm, tparams = _build(use_pallas)
    src = _src(tm.cfg, 2)
    want = jax.jit(jm.encode)(jparams, jnp.asarray(src))
    got = tm.encode(tparams, torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _prefill(pkg, model, params, src, toks, last_pos):
    if pkg == "ref":
        lg, c = jax.jit(lambda p, s, t: model.prefill(
            p, {"src_embeds": s, "tgt_tokens": t}, last_pos=last_pos))(
                params, jnp.asarray(src), jnp.asarray(toks, jnp.int32))
        return np.asarray(lg), c
    with torch.no_grad():
        lg, c = model.prefill(params, {"src_embeds": torch.from_numpy(src),
                                       "tgt_tokens": torch.as_tensor(toks)},
                              last_pos=last_pos)
    return lg.numpy(), c


@pytest.mark.parametrize("use_pallas", [True, False])
def test_model_prefill_matches_jax(use_pallas):
    """Prefill logits of a right-padded target bucket and every cache: the
    self K/V and the cross K/V of each decoder layer."""
    jm, jparams, tm, tparams = _build(use_pallas)
    L, bucket = 7, 8
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :L] = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, L)
    src = _src(tm.cfg)
    jl, jc = _prefill("ref", jm, jparams, src, toks, L - 1)
    tl, tc = _prefill("port", tm, tparams, src, toks, L - 1)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert set(tc["periods"]["pos0"]) == {"self", "cross"}
    assert tc["periods"]["pos0"]["cross"].k.shape == (
        tm.cfg.n_periods, 1, SRC, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    for t, j in cache_leaves(tc, jc):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def _filled(pkg, model, caches, batch, seq, cross_seq):
    """``init_cache(batch, seq, cross_seq=)`` with the prefill's self and
    cross caches written from position 0 (lane 0)."""
    full = model.init_cache(batch, seq, cross_seq=cross_seq)
    if pkg == "ref":
        return jax.tree.map(lambda f, p: jax.lax.dynamic_update_slice(
            f, p.astype(f.dtype), (0,) * f.ndim), full, caches)
    for f, p in zip(tree_leaves(full), tree_leaves(caches), strict=True):
        f[:, :p.shape[1], :p.shape[2]] = p
    return full


def _decode(pkg, model, params, caches, toks, pos):
    if pkg == "ref":
        lg, caches = jax.jit(model.decode_step)(
            params, caches, jnp.asarray(toks, jnp.int32),
            jnp.asarray(pos, jnp.int32))
        return np.asarray(lg), caches
    with torch.no_grad():
        lg, caches = model.decode_step(params, caches, torch.as_tensor(toks),
                                       torch.as_tensor(pos))
    return lg.numpy(), caches


def test_model_decode_matches_jax():
    """Three decode steps of a 2-slot batch (per-slot positions) against a
    cross cache of the memory's exact length, filled by a prefill of two
    prompts."""
    jm, jparams, tm, tparams = _build()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 4))
    src = _src(tm.cfg, 2)
    caches = {}
    for pkg, m, p in (("ref", jm, jparams), ("port", tm, tparams)):
        _, c = _prefill(pkg, m, p, src, toks, None)
        caches[pkg] = _filled(pkg, m, c, 2, 16, SRC)
    pos = np.array([4, 2])
    for step in range(3):
        tok = rng.integers(0, tm.cfg.vocab_size, (2, 1))
        jl, caches["ref"] = _decode("ref", jm, jparams, caches["ref"], tok,
                                    pos + step)
        tl, caches["port"] = _decode("port", tm, tparams, caches["port"], tok,
                                     pos + step)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    for t, j in cache_leaves(caches["port"], caches["ref"]):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_model_loss_and_gradients_match_jax(use_pallas):
    """The loss through the encoder and the decoder's cross-attention, and
    every gradient leaf (the encoder's included), against ``jax.grad`` of
    the reference's plain route; the port's on K4's route or the plain
    one."""
    jm, jparams, tm, tparams = _build()
    if use_pallas:
        tm = Model(dataclasses.replace(tm.cfg, use_pallas=True), device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, TGT + 1))
    batch = {"src_embeds": _src(tm.cfg, 2),
             "tgt_tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32),
             "loss_mask": (rng.random((2, TGT)) > 0.2).astype(np.float32)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, _ = tm.loss(tparams, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=RTOL, atol=ATOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(tgrads) == len(jleaves)
    for t, j in zip(tgrads, jleaves, strict=True):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


def _greedy(pkg, model, params, src, prompt, steps, cross_seq):
    """Greedy continuation: prefill the prompt, then ``steps`` decode steps
    against a cross cache of ``cross_seq`` rows (the memory's rows, then
    zeros)."""
    lg, c = _prefill(pkg, model, params, src, np.asarray([prompt]), None)
    caches = _filled(pkg, model, c, 1, 32, cross_seq)
    toks = [int(lg[0, 0, :model.cfg.vocab_size].argmax())]
    first = None
    for i in range(steps):
        lg, caches = _decode(pkg, model, params, caches, [[toks[-1]]],
                             len(prompt) + i)
        first = lg if first is None else first
        toks.append(int(lg[0, 0, :model.cfg.vocab_size].argmax()))
    return toks, first


def test_cross_cache_longer_than_memory_attends_its_zero_rows():
    """A cross cache of 16 rows for a memory of 10 (``init_cache(...,
    cross_seq=16)``): the decode attends to the 6 zero rows too, since
    ``apply_layer`` passes no ``cross_len``, so its logits and tokens
    differ from those of a cache of the memory's exact length.  Both
    packages give the same tokens on each; ``cross_len`` = 10 on the long
    cache would give the exact-length cache's output."""
    jm, jparams, tm, tparams = _build()
    src = _src(tm.cfg, seed=7)
    prompt = [int(t) for t in np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, 5)]
    runs = {(pkg, n): _greedy(pkg, m, p, src, prompt, 6, n)
            for pkg, m, p in (("ref", jm, jparams), ("port", tm, tparams))
            for n in (SRC, 16)}
    for n in (SRC, 16):
        assert runs[("port", n)][0] == runs[("ref", n)][0]
        np.testing.assert_allclose(runs[("port", n)][1], runs[("ref", n)][1],
                                   rtol=RTOL, atol=ATOL)
    exact, padded = runs[("port", SRC)], runs[("port", 16)]
    assert exact[0] != padded[0]
    assert float(np.abs(exact[1] - padded[1]).max()) > 1e-2
    # The layer's cross-attention on the long cache with cross_len = 10
    # gives the exact-length cache's output.
    jcfg, cfg = _cfgs(qkv_bias=True)
    jp, tp = _attn(jcfg)
    mem = torch.from_numpy(_np((1, SRC, cfg.d_model), 4))
    kv = tf.cross_kv(tp, cfg, mem)
    long = attention.KVCache(
        k=torch.cat([kv.k, torch.zeros((1, 6) + kv.k.shape[2:])], 1),
        v=torch.cat([kv.v, torch.zeros((1, 6) + kv.v.shape[2:])], 1))
    x = torch.from_numpy(_np((1, 1, cfg.d_model), 9))
    want, _ = attention.attention_decode(tp, cfg, x, kv, None, cross=True)
    got, _ = attention.attention_decode(tp, cfg, x, long, None, cross=True,
                                        cross_len=SRC)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    pad, _ = attention.attention_decode(tp, cfg, x, long, None, cross=True)
    assert float((pad - want).abs().max()) > 1e-3
