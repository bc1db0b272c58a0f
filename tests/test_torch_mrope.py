"""Port parity of M-RoPE and embeds input (``models/layers.py::apply_rope``
with ``mrope_sections``, ``Model._embed``/``decode_step`` in embeds mode)
and the reduced ``qwen2-vl-7b`` against the JAX package, on the same numpy
inputs and bridged weights, in f32 on the CPU, at the reference's f32
tolerance (rtol 5e-4 / atol 5e-5).

Every M-RoPE case but the broadcast one uses position streams that differ,
an image block as Qwen2-VL lays one out (text, then a grid of patches at
one temporal id with the h and w streams over its rows and columns, then
text from max + 1): with three equal streams M-RoPE is plain RoPE, and a
test could not tell them apart.

The decode property of the reference, pinned here in both packages:
``attention_decode`` ropes the new token's q and k with the cache index
``pos``, and the ``(B, 3, 1)`` positions an embeds-mode ``decode_step``
takes are never read.  So a prompt whose streams differ continues at
t = h = w = index, where Qwen2-VL continues at max(position) + 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models.layers import apply_rope as jax_apply_rope
from repro_torch.configs import get_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.layers import apply_rope
from repro_torch.tree import tree_leaves
from test_torch_model import cache_leaves, port_cfg

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

RTOL, ATOL = 5e-4, 5e-5
ARCH = "qwen2-vl-7b"


def vl_positions(n_before: int, grid: int, n_after: int,
                 pad_to: int | None = None) -> np.ndarray:
    """(3, S) M-RoPE position ids of text, one image block of grid x grid
    patches, then text (S = n_before + grid**2 + n_after), padded to
    ``pad_to`` by positions that go on counting."""
    t, h, w = [], [], []
    for i in range(n_before):
        t.append(i), h.append(i), w.append(i)
    for r in range(grid):
        for c in range(grid):
            t.append(n_before), h.append(n_before + r), w.append(n_before + c)
    nxt = max(t + h + w) + 1
    n = n_after + ((pad_to or 0) - (n_before + grid * grid + n_after))
    for i in range(max(n, n_after)):
        t.append(nxt + i), h.append(nxt + i), w.append(nxt + i)
    return np.asarray([t, h, w], np.int32)


def test_config_matches_reference_at_published_widths():
    for reduced in (False, True):
        assert get_config(ARCH, reduced=reduced) == port_cfg(
            jax_get_config(ARCH, reduced=reduced))
    c = get_config(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_q_heads, c.n_kv_heads,
            c.head_dim, c.d_ff, c.vocab_size) == \
        (28, 3584, 28, 32, 4, 128, 18944, 152064)
    assert c.input_mode == "embeds" and c.mrope_sections == (16, 24, 24)
    assert c.qkv_bias


@pytest.mark.parametrize("sections,d", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_apply_rope_with_differing_streams_matches_jax(sections, d):
    """At the reduced and the published sections: q-shaped inputs roped
    by an image block's three streams, against the reference; and not
    plain RoPE on the temporal stream."""
    rng = np.random.default_rng(0)
    pos = np.stack([vl_positions(3, 4, 5), vl_positions(1, 3, 14)])
    x = rng.standard_normal((2, pos.shape[-1], 3, d)).astype(np.float32)
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                     sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    plain = apply_rope(torch.from_numpy(x), torch.from_numpy(pos[:, 0]), 1e6)
    assert float((got - plain).abs().max()) > 1e-2


def test_apply_rope_broadcasts_a_two_dim_position_input():
    """(B, S) positions are three equal streams: the same values as the
    explicit (B, 3, S) input and as plain RoPE, in both packages."""
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 50, (2, 9)).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal((2, 9, 2, 16)).astype(np.float32))
    p2 = torch.from_numpy(pos)
    got = apply_rope(x, p2, 1e4, (2, 3, 3))
    assert torch.equal(got, apply_rope(x, p2[:, None].expand(2, 3, 9), 1e4,
                                       (2, 3, 3)))
    assert torch.equal(got, apply_rope(x, p2, 1e4))
    want = jax_apply_rope(jnp.asarray(x.numpy()), jnp.asarray(pos), 1e4,
                          (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(AssertionError):
        apply_rope(x, p2, 1e4, (2, 3, 4))


# ------------------------------------------------------------- the model
def _build(use_pallas=False):
    jcfg = jax_get_config(ARCH, reduced=True, use_pallas=use_pallas)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = Model(port_cfg(jcfg), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, tm, tparams


def _embeds(cfg, b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


L, BUCKET = 13, 16


def _prompt(cfg):
    """A 13-token prompt (2 text, a 3 x 3 image block, 2 text) padded to
    the bucket of 16: embeds and its (1, 3, 16) positions."""
    x = np.zeros((1, BUCKET, cfg.d_model), np.float32)
    x[:, :L] = _embeds(cfg, 1, L)
    return x, vl_positions(2, 3, 2, pad_to=BUCKET)[None]


@pytest.mark.parametrize("use_pallas", [True, False])
def test_model_prefill_matches_jax(use_pallas):
    """Embeds input with differing streams: logits and caches, on the
    kernel route (the reference's Pallas prefill in interpret mode; the
    port's K1 wrapper, its plain version on the CPU) and the plain one."""
    jm, jparams, tm, tparams = _build(use_pallas)
    x, pos = _prompt(tm.cfg)
    jl, jc = jax.jit(lambda p, e, q: jm.prefill(
        p, {"embeds": e, "positions": q}, last_pos=L - 1))(
            jparams, jnp.asarray(x), jnp.asarray(pos))
    tl, tc = tm.prefill(tparams, {"embeds": torch.from_numpy(x),
                                  "positions": torch.from_numpy(pos)},
                        last_pos=L - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    for t, j in cache_leaves(tc, jc):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_model_decode_with_embeds_matches_jax():
    """Three decode steps of a 2-slot batch with embeds input and (B, 3, 1)
    positions, per-slot cache positions."""
    jm, jparams, tm, tparams = _build()
    jdecode = jax.jit(jm.decode_step)
    jcache, tcache = jm.init_cache(2, 32), tm.init_cache(2, 32)
    pos = np.array([0, 3])
    for step in range(3):
        e = _embeds(tm.cfg, 2, 1, seed=5 + step)
        p3 = np.full((2, 3, 1), 7 * step, np.int32)
        jlog, jcache = jdecode(jparams, jcache,
                               {"embeds": jnp.asarray(e),
                                "positions": jnp.asarray(p3)},
                               jnp.asarray(pos + step, jnp.int32))
        tlog, tcache = tm.decode_step(
            tparams, tcache, {"embeds": torch.from_numpy(e),
                              "positions": torch.from_numpy(p3)},
            torch.as_tensor(pos + step))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=RTOL, atol=ATOL)
    for t, j in cache_leaves(tcache, jcache):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_model_loss_and_gradients_match_jax():
    """Embeds input with an image block in each row: the loss and every
    gradient leaf against ``jax.grad`` (the unused embedding table's
    gradient is zero in both)."""
    jm, jparams, tm, tparams = _build()
    rng = np.random.default_rng(3)
    pos = np.stack([vl_positions(1, 3, 2), vl_positions(3, 2, 5)])
    batch = {"embeds": _embeds(tm.cfg, 2, 12),
             "positions": pos,
             "targets": rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(
                 np.int32),
             "loss_mask": (rng.random((2, 12)) > 0.2).astype(np.float32)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, _ = tm.loss(tparams, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True,
                                 materialize_grads=True)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=RTOL, atol=ATOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(tgrads) == len(jleaves)
    for t, j in zip(tgrads, jleaves, strict=True):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


def _greedy(pkg, model, params, x, pos, steps, mode):
    """Greedy continuation of the 13-token prompt, each new token's embeds
    the LM table's row: ``decode`` through ``decode_step`` (the (B, 3, 1)
    positions set to Qwen2-VL's max + 1 continuation), ``prefill`` through
    a prefill over the whole sequence, the new tokens at max + 1 onward on
    all three streams.  Returns the tokens and the first step's logits."""
    cfg = model.cfg
    table = np.asarray(params["embed"]["table"], np.float32)
    nxt = int(pos[0, :, :L].max()) + 1
    seq_x, seq_p = x[:, :L].copy(), pos[:, :, :L].copy()
    if pkg == "ref":
        prefill = jax.jit(lambda p, e, q: model.prefill(
            p, {"embeds": e, "positions": q}))
        logits, caches = prefill(params, jnp.asarray(seq_x),
                                 jnp.asarray(seq_p))
        logits = np.asarray(logits)
    else:
        with torch.no_grad():
            logits, caches = model.prefill(
                params, {"embeds": torch.from_numpy(seq_x),
                         "positions": torch.from_numpy(seq_p)})
        logits = logits.numpy()
    toks = [int(logits[0, 0, :cfg.vocab_size].argmax())]
    first = None
    if mode == "decode":
        if pkg == "ref":
            cache = model.init_cache(1, 32)
            cache = jax.tree.map(
                lambda f, p: jax.lax.dynamic_update_slice(
                    f, p.astype(f.dtype), (0,) * f.ndim), cache, caches)
            decode = jax.jit(model.decode_step)
        else:
            cache = model.init_cache(1, 32)
            for full, part in zip(tree_leaves(cache), tree_leaves(caches)):
                full[:, :, :L] = part
    for i in range(steps):
        e = table[toks[-1]][None, None]
        p3 = np.full((1, 3, 1), nxt + i, np.int32)
        if mode == "decode":
            if pkg == "ref":
                lg, cache = decode(params, cache,
                                   {"embeds": jnp.asarray(e),
                                    "positions": jnp.asarray(p3)},
                                   jnp.int32(L + i))
                lg = np.asarray(lg)
            else:
                with torch.no_grad():
                    lg, cache = model.decode_step(
                        params, cache, {"embeds": torch.from_numpy(e),
                                        "positions": torch.from_numpy(p3)},
                        L + i)
                lg = lg.numpy()
        else:
            seq_x = np.concatenate([seq_x, e], axis=1)
            seq_p = np.concatenate([seq_p, p3], axis=2)
            if pkg == "ref":
                lg = np.asarray(prefill(params, jnp.asarray(seq_x),
                                        jnp.asarray(seq_p))[0])
            else:
                with torch.no_grad():
                    lg = model.prefill(
                        params, {"embeds": torch.from_numpy(seq_x),
                                 "positions": torch.from_numpy(seq_p)})[0]
                lg = lg.numpy()
        first = lg if first is None else first
        toks.append(int(lg[0, 0, :cfg.vocab_size].argmax()))
    return toks, first


def test_decode_ropes_at_the_cache_index_as_the_reference_does():
    """The reference's decode ignores the (B, 3, 1) positions: after a
    prompt with an image block (max position 6 at index 12), decode
    continues at t = h = w = 13, 14, ... where Qwen2-VL continues at 7, 8,
    ...  Both packages give the same tokens on each route; the decode's
    first logits equal a prefill's whose new token sits at the index, and
    miss the max + 1 prefill's; the tokens of the two routes differ."""
    jm, jparams, tm, tparams = _build()
    x, pos = _prompt(tm.cfg)
    runs = {(pkg, mode): _greedy(pkg, m, p, x, pos, 6, mode)
            for pkg, m, p in (("ref", jm, jparams), ("port", tm, tparams))
            for mode in ("decode", "prefill")}
    for mode in ("decode", "prefill"):
        assert runs[("port", mode)][0] == runs[("ref", mode)][0]
        np.testing.assert_allclose(runs[("port", mode)][1],
                                   runs[("ref", mode)][1], rtol=RTOL,
                                   atol=ATOL)
    dec, pre = runs[("port", "decode")], runs[("port", "prefill")]
    assert dec[0] != pre[0]
    assert float(np.abs(dec[1] - pre[1]).max()) > 1e-2
    # The decode's first step is a prefill with the new token at index 13.
    table = tparams["embed"]["table"].numpy()
    seq_x = np.concatenate([x[:, :L], table[dec[0][0]][None, None]], axis=1)
    seq_p = np.concatenate([pos[:, :, :L], np.full((1, 3, 1), L, np.int32)],
                           axis=2)
    with torch.no_grad():
        at_index, _ = tm.prefill(tparams, {
            "embeds": torch.from_numpy(seq_x),
            "positions": torch.from_numpy(seq_p)})
    np.testing.assert_allclose(dec[1], at_index.numpy(), rtol=RTOL,
                               atol=ATOL)
    # And the positions it takes are not read: any other ids, same bits.
    with torch.no_grad():
        _, pre_c = tm.prefill(tparams, {"embeds": torch.from_numpy(x[:, :L]),
                                        "positions": torch.from_numpy(
                                            pos[:, :, :L])})
    outs = []
    for ids in (0, 99):
        cache = tm.init_cache(1, 32)
        for full, part in zip(tree_leaves(cache), tree_leaves(pre_c)):
            full[:, :, :L] = part
        with torch.no_grad():
            lg, _ = tm.decode_step(tparams, cache, {
                "embeds": torch.from_numpy(seq_x[:, L:]),
                "positions": torch.full((1, 3, 1), ids)}, L)
        outs.append(lg)
    assert torch.equal(outs[0], outs[1])
