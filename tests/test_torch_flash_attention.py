"""Port parity: the flash-attention op (K4's route) against the JAX package.

The same numpy inputs, made from seeds, go through the reference's ``mha``
(its Pallas kernel in interpret mode, and its plain path) and the port's
``mha`` on the CPU, where the port's kernel wrapper takes its plain version:
the shapes of ``tests/test_kernels.py``'s flash-attention cases (causal and
not, GQA, the x30-magnitude logits) plus Sq != Skv and ragged S, at the
reference's tolerances (f32 rtol 5e-4 / atol 5e-5, bf16 2e-2).  The port's
gradients (autograd through its plain version on the CPU; the CUDA backward
kernels are held against the same plain version in ``test_torch_cuda.py``)
match ``jax.grad`` of the reference's plain path within f32 rtol 1e-3 /
atol 1e-4.  The reference's results are computed once per module.

A plain-torch model of the bf16 tensor-core kernels' rounding points (the
scale on the f32 scores, P, dS, P^T and dS^T as hi + lo bf16 terms, the
per-head dK/dV partials summed in head order) is held against
the port's plain version and autograd through it at the bf16 tolerance, on
shapes with the x30 logits and GQA; more tests show why: P or dS^T rounded
once misses that tolerance at the x30 logits, dS rounded once misses dQ's
at the x30 logits with GQA, and autograd on bf16 leaves misses the exact
gradient at one key and group 8.  The same model's forward, causal with
Sq == Skv, is K1's bf16 kernel, held against the JAX package's prefill
reference at every serve bucket.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha as jax_mha
from repro.kernels.prefill.ref import prefill_ref as jax_prefill_ref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import mha

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=5e-4, atol=5e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)

# (b, sq, skv, hq, hkv, d, magnitude): tests/test_kernels.py:80-126, then
# Sq != Skv and ragged lengths (the reference's plain path only: its Pallas
# wrapper needs blocks that divide S).
KERNEL_SHAPES = [(2, 128, 128, 4, 2, 64, 1.0), (1, 256, 256, 2, 2, 32, 1.0),
                 (2, 64, 64, 4, 1, 16, 1.0), (1, 64, 64, 1, 1, 16, 30.0)]
PLAIN_SHAPES = [(1, 40, 72, 4, 2, 16, 1.0), (1, 72, 40, 4, 2, 16, 1.0),
                (1, 100, 100, 16, 2, 32, 1.0)]
CASES = [(shape, causal, dtype)
         for shape in KERNEL_SHAPES + PLAIN_SHAPES
         for causal in (True, False)
         for dtype in ("float32", "bfloat16")]


def _inputs(shape, seed=0):
    b, sq, skv, hq, hkv, d, mag = shape
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, sq, hq, d)) * mag
    k = r.standard_normal((b, skv, hkv, d)) * mag
    v = r.standard_normal((b, skv, hkv, d))
    dout = r.standard_normal((b, sq, hq, d))
    return [x.astype(np.float32) for x in (q, k, v, dout)]


def _jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@functools.partial(jax.jit, static_argnames=("causal",))
def _jax_plain(q, k, v, causal):
    return jax_mha(q, k, v, causal=causal, use_pallas=False)


@functools.partial(jax.jit, static_argnames=("causal",))
def _jax_plain_and_grads(q, k, v, dout, causal):
    out, vjp = jax.vjp(lambda *a: _jax_plain(*a, causal=causal), q, k, v)
    return out, vjp(dout)


@pytest.fixture(scope="module")
def reference():
    """Per case: the reference's Pallas (interpret) and plain outputs, and
    in f32 the gradients of sum(out * dout) through its plain path."""
    out = {}
    for shape, causal, dtype in CASES:
        q, k, v, dout = _inputs(shape)
        args = [_jax(x, dtype) for x in (q, k, v)]
        res = {}
        if dtype == "float32":
            plain, grads = _jax_plain_and_grads(*args, dout, causal)
            res["grads"] = [np.asarray(g) for g in grads]
        else:
            plain = _jax_plain(*args, causal)
        res["plain"] = np.asarray(plain, np.float32)
        if shape in KERNEL_SHAPES:
            res["pallas"] = np.asarray(jax_mha(
                *args, causal=causal, use_pallas=True, interpret=True,
                block_q=32, block_k=32), np.float32)
        out[(shape, causal, dtype)] = res
    return out


@pytest.mark.parametrize("shape,causal,dtype", CASES)
def test_mha_matches_reference(reference, shape, causal, dtype):
    q, k, v, _ = _inputs(shape)
    got = mha(*(_torch(x, dtype) for x in (q, k, v)), causal=causal,
              use_pallas=True)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (shape[0], shape[1], shape[3], shape[5])
    got = got.float().numpy()
    assert np.isfinite(got).all()
    ref = reference[(shape, causal, dtype)]
    for route in ("pallas", "plain"):
        if route in ref:
            np.testing.assert_allclose(got, ref[route], **TOL[dtype],
                                       err_msg=route)


@pytest.mark.parametrize("shape,causal", [(s, c) for s in KERNEL_SHAPES
                                          + PLAIN_SHAPES for c in (True,
                                                                   False)])
def test_mha_gradients_match_jax_grad(reference, shape, causal):
    q, k, v, dout = _inputs(shape)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = mha(*leaves, causal=causal, use_pallas=True)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    want = reference[(shape, causal, "float32")]["grads"]
    for name, g, w in zip("qkv", grads, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_kernel_route_and_plain_route_agree_on_cpu():
    """On the CPU ``use_pallas=True`` takes the wrapper, which runs the
    plain version: both routes give the same bits and launch nothing."""
    q, k, v, _ = _inputs((1, 48, 48, 4, 2, 16, 1.0), seed=3)
    before = dict(fa.LAUNCHES)
    a = mha(*map(torch.from_numpy, (q, k, v)), use_pallas=True)
    b = mha(*map(torch.from_numpy, (q, k, v)), use_pallas=False)
    assert torch.equal(a, b)
    assert fa.LAUNCHES == before


def test_wrapper_validates_and_raises_off_cuda_and_cpu():
    q = torch.zeros((4, 8, 16))
    k = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q, k, k, group=3)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, torch.zeros((2, 8, 32)), torch.zeros((2, 8, 32)),
                           group=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"), group=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_fwd(q, k, k, group=2)


# ------------------------------------------ the bf16 kernels' rounding points
# A plain-torch model of the arithmetic of K4's bf16 tensor-core kernels
# (csrc/flash_attention.cu): products of bf16 operands summed in f32, the
# 1/sqrt(D) scale on the f32 scores, the online softmax over 64-key tiles,
# P entering P V as two bf16 terms (hi = bf16(p), lo = bf16(p - hi)), P^T
# and dS^T entering dV = P^T dO and dK = dS^T Q the same way, each q head's
# dK and dV partial summed over the group in head order and rounded once,
# dS entering dQ = dS K the same way over 64-key tiles, the scale last.
# Held against the plain version and autograd through it at phase 10's bf16
# tolerances, the model shows which rounding fits before any run on the
# card.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
NEG = -1e30


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def _once(x):
    return x.to(torch.bfloat16).float()


def _mask(sq, skv, causal, k0=0, kn=None):
    kn = skv - k0 if kn is None else kn
    qi = torch.arange(sq)[:, None]
    kj = torch.arange(k0, k0 + kn)[None, :]
    return qi >= kj if causal else torch.ones((sq, kn), dtype=torch.bool)


def _model_fwd(q, k, v, causal, group, round_p=_split):
    """(out in bf16, lse, out32) as the bf16 forward kernel forms them."""
    d = q.shape[-1]
    scale = d ** -0.5
    kf = torch.repeat_interleave(k, group, 0).float()
    vf = torch.repeat_interleave(v, group, 0).float()
    bh, sq, _ = q.shape
    skv = k.shape[1]
    m = torch.full((bh, sq, 1), NEG)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    for k0 in range(0, skv, 64):
        kn = min(64, skv - k0)
        s = torch.einsum("bqd,bkd->bqk", q.float(), kf[:, k0:k0 + kn]) * scale
        s = torch.where(_mask(sq, skv, causal, k0, kn), s, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", round_p(p),
                                         vf[:, k0:k0 + kn])
        m = m_new
    l = l.clamp_min(1e-30)
    out32 = acc / l
    return out32.to(torch.bfloat16), (m + torch.log(l))[..., 0], out32


def _model_bwd(q, k, v, out32, lse, dout, causal, group, round_ds=_split,
               round_dq=_split):
    """(dq, dk, dv) in bf16 as the bf16 dQ kernel (dS entering dS K over
    64-key tiles, the scale last) and the bf16 dK/dV kernel with its
    head-order reduction form them."""
    d = q.shape[-1]
    scale = d ** -0.5
    skv = k.shape[1]
    kf = torch.repeat_interleave(k, group, 0).float()
    vf = torch.repeat_interleave(v, group, 0).float()
    qf, gf = q.float(), dout.float()
    drow = (gf * out32).sum(-1, keepdim=True)
    visible = _mask(q.shape[1], skv, causal)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    p = torch.where(visible, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bqd,bkd->bqk", gf, vf) - drow)
    dq = torch.zeros_like(qf)
    for k0 in range(0, skv, 64):
        dq = dq + torch.einsum("bqk,bkd->bqd", round_dq(ds[..., k0:k0 + 64]),
                               kf[:, k0:k0 + 64])
    dq = dq * scale
    dv_h = torch.einsum("bqk,bqd->bkd", _split(p), gf)
    dk_h = torch.einsum("bqk,bqd->bkd", round_ds(ds), qf) * scale
    dk = dk_h.reshape(-1, group, skv, d)
    dv = dv_h.reshape(-1, group, skv, d)
    dk_sum, dv_sum = dk[:, 0], dv[:, 0]
    for h in range(1, group):
        dk_sum, dv_sum = dk_sum + dk[:, h], dv_sum + dv[:, h]
    return (dq.to(torch.bfloat16), dk_sum.to(torch.bfloat16),
            dv_sum.to(torch.bfloat16))


def _bf16_case(shape, seed):
    b, sq, skv, hq, hkv, d, mag = shape
    r = np.random.default_rng(seed)

    def draw(s, m=1.0):
        return torch.from_numpy((r.standard_normal(s) * m).astype(
            np.float32)).to(torch.bfloat16)

    return (draw((b * hq, sq, d), mag), draw((b * hkv, skv, d), mag),
            draw((b * hkv, skv, d)), draw((b * hq, sq, d)), hq // hkv)


def _margins(got, want):
    """Per tensor, max over elements of |got - want| - (atol + rtol |want|):
    <= 0 within the bf16 tolerance."""
    return [float(((g.detach().float() - w.detach().float()).abs()
                   - (BF16_TOL["atol"]
                      + BF16_TOL["rtol"] * w.detach().float().abs()))
                  .max()) for g, w in zip(got, want, strict=True)]


def _plain_and_grads(q, k, v, dout, causal, group, dtype=torch.bfloat16):
    leaves = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention_ref(*leaves, causal=causal, group=group)
    return [out, *torch.autograd.grad(out, leaves, dout.to(dtype))]


def _model(q, k, v, dout, causal, group, round_p=_split, round_ds=_split,
           round_dq=_split):
    out, lse, out32 = _model_fwd(q, k, v, causal, group, round_p)
    return [out, *_model_bwd(q, k, v, out32, lse, dout, causal, group,
                             round_ds, round_dq)]


# (b, sq, skv, hq, hkv, d, magnitude): the x30 logits with and without GQA
# (seeds 0-3), the reference's GQA kernel-test shape, ragged and Sq != Skv
# both ways, group 8 across tile edges.
MODEL_CASES = [((1, 64, 64, 1, 1, 16, 30.0), s) for s in range(4)] + \
    [((1, 64, 64, 4, 2, 16, 30.0), s) for s in range(4)] + \
    [((2, 128, 128, 4, 2, 64, 1.0), 0), ((1, 100, 100, 4, 2, 16, 1.0), 0),
     ((1, 130, 48, 4, 2, 64, 1.0), 0), ((1, 40, 72, 4, 2, 16, 1.0), 0),
     ((1, 129, 127, 8, 1, 32, 1.0), 0)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,seed", MODEL_CASES)
def test_bf16_kernel_rounding_fits_the_tolerance(shape, seed, causal):
    q, k, v, dout, group = _bf16_case(shape, seed)
    got = _model(q, k, v, dout, causal, group)
    want = _plain_and_grads(q, k, v, dout, causal, group)
    assert all(torch.isfinite(t.float()).all() for t in got)
    margins = _margins(got, want)
    assert max(margins) <= 0, dict(zip(("out", "dq", "dk", "dv"), margins))


def test_bf16_output_rounds_from_out32_bitwise():
    """The forward's bf16 output is its f32 output rounded once, the
    contract the dQ kernel's row term relies on."""
    q, k, v, _, group = _bf16_case((1, 100, 100, 4, 2, 16, 1.0), 1)
    out, lse, out32 = _model_fwd(q, k, v, True, group)
    assert torch.equal(out32.to(torch.bfloat16), out)
    assert lse.dtype == torch.float32 and torch.isfinite(lse).all()


@pytest.mark.parametrize("what", ["p", "ds"])
def test_single_bf16_rounding_misses_x30_tolerance(what):
    """Why the kernels take P and dS^T as hi + lo: rounded to bf16 once, P
    (through the row term rowsum(dO * O) of dQ) or dS^T (through dK) puts
    the x30-logit case outside the bf16 tolerance for some of seeds 0-19,
    where the split stays inside for all of them."""
    shape = (1, 64, 64, 1, 1, 16, 30.0)
    once = {"p": dict(round_p=_once), "ds": dict(round_ds=_once)}[what]
    worst_once, worst_split = -1.0, -1.0
    for seed in range(20):
        q, k, v, dout, group = _bf16_case(shape, seed)
        for causal in (True, False):
            want = _plain_and_grads(q, k, v, dout, causal, group)
            worst_once = max(worst_once, *_margins(
                _model(q, k, v, dout, causal, group, **once), want))
            worst_split = max(worst_split, *_margins(
                _model(q, k, v, dout, causal, group), want))
    assert worst_once > 0 >= worst_split, (worst_once, worst_split)


@pytest.mark.parametrize("shape,once_fits", [
    ((1, 64, 64, 1, 1, 16, 30.0), True), ((1, 128, 128, 8, 1, 64, 30.0),
                                          False)], ids=["reference", "gqa"])
def test_dq_takes_ds_as_hi_plus_lo(shape, once_fits):
    """Why the dQ kernel takes dS as hi + lo: rounded to bf16 once, dS still
    fits dQ's tolerance at the reference's x30 case (one head, D = 16), but
    not at the x30 logits with 8 q heads a KV head and D = 64 for some of
    seeds 0-19; the split fits both.  Held against the exact gradient
    (autograd in f32 on the same bf16 values), since at that shape the
    oracle on bf16 leaves misses dK by itself."""
    worst_once, worst_split = -1.0, -1.0
    for seed in range(20):
        q, k, v, dout, group = _bf16_case(shape, seed)
        for causal in (True, False):
            exact = _plain_and_grads(q, k, v, dout, causal, group,
                                     torch.float32)
            worst_once = max(worst_once, _margins(_model(
                q, k, v, dout, causal, group, round_dq=_once)[1:2],
                exact[1:2])[0])
            worst_split = max(worst_split, *_margins(
                _model(q, k, v, dout, causal, group), exact))
    assert worst_split <= 0, worst_split
    assert (worst_once <= 0) == once_fits, worst_once


# K1's bf16 kernel is the forward above, causal with Sq == Skv: held against
# the JAX package's prefill reference (f32 softmax over the full logits,
# out in bf16) at q (8, S, 128), k/v (1, S, 128), every serve bucket, and
# at the x30 logits.
@pytest.mark.parametrize("s,mag", [(s, 1.0) for s in (16, 32, 64, 128, 256,
                                                       512)] + [(128, 30.0)])
def test_k1_bf16_model_matches_jax_prefill_reference(s, mag):
    q, k, v, _, group = _bf16_case((1, s, s, 8, 1, 128, mag), 0)
    out, _, _ = _model_fwd(q, k, v, True, group)
    want, _, _ = jax_prefill_ref(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                   for t in (q, k, v)), group=group)
    assert want.dtype == jnp.bfloat16
    margin = _margins([out], [torch.from_numpy(np.asarray(want, np.float32))])
    assert margin[0] <= 0, margin


def test_bf16_oracle_misses_exact_gradient_at_one_key_group_8():
    """Why the tile-edge cases on the card hold bf16 gradients against
    autograd through the plain version in f32: with one key and 8 q heads
    a head's dV is a sum of 129 rows of dO, and autograd on bf16 leaves
    rounds each head's dV to bf16 before summing the group, which misses
    the exact gradient by more than the tolerance; the kernels sum the
    heads' f32 partials and round once, and stay within it."""
    q, k, v, dout, group = _bf16_case((1, 129, 1, 8, 1, 64, 1.0), 0)
    exact = _plain_and_grads(q, k, v, dout, False, group, torch.float32)
    bf16_leaves = _plain_and_grads(q, k, v, dout, False, group)
    assert _margins(bf16_leaves[3:], exact[3:])[0] > 0
    model = _model(q, k, v, dout, False, group)
    assert max(_margins(model, exact)) <= 0
