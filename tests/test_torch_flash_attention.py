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
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha as jax_mha
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
