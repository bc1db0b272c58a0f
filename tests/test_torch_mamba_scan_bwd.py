"""Port parity: the SSD scan's gradient (``ref.ssd_scan_bwd_plain``, what
K5's backward kernel is held against on the card) on the CPU.

The same numpy inputs go through ``ssd_scan_bwd_plain``, through torch
autograd over ``ssd_scan_plain``, and through ``jax.grad`` of the
reference's plain route: ``repro.kernels.mamba_scan.ops.ssd(...,
use_pallas=False)`` in (x, dt, B, C) against the port's ``ssd`` on the
kernel route (``use_pallas=True``, whose CPU backward is
``ssd_scan_bwd_plain``), and the grouped chunked scan that route calls
(``ssd_chunked_grouped``) in (xdt, la, B, C) against
``ssd_scan_bwd_plain`` directly.  Cases: one head a group and several, S
not dividing the chunk, the final state's gradient absent and non-zero, f32
at the reference's f32 tolerance (rtol 5e-4 / atol 5e-5) and bf16 at 2e-2.
At steep decays the port's f64 prefix sum already leaves the reference's
f32 one (``test_torch_mamba_scan.py::
test_k5_f32_prefix_sum_diverges_from_reference_at_steep_decays``), so there
the gradient is held against the f64 recurrence's autograd instead, as a
relative Frobenius error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ops import ssd as jax_ssd
from repro.kernels.mamba_scan.ops import ssd_chunked_grouped as jax_grouped
from repro_torch.kernels.mamba_scan import mamba_scan as k5
from repro_torch.kernels.mamba_scan.ops import ssd
from repro_torch.kernels.mamba_scan.ref import (
    ssd_scan_bwd_plain,
    ssd_scan_plain,
    ssd_scan_ref,
    suffix_sum,
)

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

F32_TOL = dict(rtol=5e-4, atol=5e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
NAMES = ("dxdt", "dla", "db", "dc")


def _tol(dtype):
    return BF16_TOL if dtype in (torch.bfloat16, jnp.bfloat16) else F32_TOL


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=name)


def _draw(bsz, s, h, p, g, n, seed, la_floor=None):
    """x, dt (softplus-sized), a < 0, B, C, dy (B, S, H, P) and dstate (B,
    H, P, N) in f32 numpy, as the reference's kernel test draws its inputs;
    with ``la_floor`` dt is scaled so that the steepest la = dt a is it."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = (np.abs(r.standard_normal((bsz, s, h))) * 0.1 + 0.01).astype(
        np.float32)
    a = (-np.abs(r.standard_normal(h)) - 0.1).astype(np.float32)
    if la_floor is not None:
        dt *= np.float32(la_floor / (dt * a).min())
    bm = r.standard_normal((bsz, s, g, n)).astype(np.float32)
    cm = r.standard_normal((bsz, s, g, n)).astype(np.float32)
    dy = r.standard_normal((bsz, s, h, p)).astype(np.float32)
    dstate = r.standard_normal((bsz, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, dy, dstate


def _flat(x, dt, a, bm, cm, dy, dstate):
    """The kernel's layout in torch f32: xdt, la, dy (BH, S, .), B and C
    per group (BG, S, N), dstate (BH, P, N)."""
    bsz, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    t = torch.from_numpy
    xdt = (t(x) * t(dt)[..., None]).transpose(1, 2).reshape(bsz * h, s, p)
    la = (t(dt) * t(a)).transpose(1, 2).reshape(bsz * h, s)
    bg, cg = (t(m).transpose(1, 2).reshape(bsz * g, s, n) for m in (bm, cm))
    dyf = t(dy).transpose(1, 2).reshape(bsz * h, s, p)
    return xdt, la, bg, cg, dyf, t(dstate).reshape(bsz * h, p, n)


# (batch, s, heads, p, groups, n, chunk): the reference's kernel-test
# shapes (rep 2 and 2), one group of 4 heads, S not dividing the chunk, one
# head a group, and a single chunk.
CASES = [(2, 96, 4, 16, 2, 8, 32), (1, 64, 4, 8, 1, 16, 32),
         (1, 90, 2, 8, 1, 4, 32), (2, 50, 3, 8, 3, 6, 16),
         (1, 40, 2, 8, 2, 5, 64)]


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("bsz,s,h,p,g,n,chunk", CASES)
def test_bwd_plain_matches_autograd_through_the_forward(bsz, s, h, p, g, n,
                                                        chunk, with_dstate):
    """``ssd_scan_bwd_plain`` is the derivative of ``ssd_scan_plain``:
    against torch autograd through it, B and C repeated per head there."""
    xdt, la, bg, cg, dy, dstate = _flat(*_draw(bsz, s, h, p, g, n, 0))
    rep = h // g
    dstate = dstate if with_dstate else None
    leaves = [t.clone().requires_grad_(True) for t in (xdt, la, bg, cg)]
    y, state = ssd_scan_plain(
        leaves[0], leaves[1], torch.repeat_interleave(leaves[2], rep, 0),
        torch.repeat_interleave(leaves[3], rep, 0), chunk=chunk)
    loss = (y * dy).sum() + (0 if dstate is None else (state * dstate).sum())
    loss.backward()
    got = ssd_scan_bwd_plain(xdt, la, bg, cg, dy, dstate, chunk=chunk,
                             rep=rep)
    for name, gv, leaf in zip(NAMES, got, leaves, strict=True):
        assert gv.dtype == torch.float32 and gv.shape == leaf.shape, name
        _close(gv, leaf.grad, F32_TOL, name)


def _jax_grouped_grads(xdt, la, bg, cg, dy, dstate, bsz, g, chunk, dtype):
    """jax.grad of the reference's ``ssd_chunked_grouped`` (what
    ``ops.ssd(use_pallas=False)`` calls) in its (B, G, R, S, .) layout,
    against the cotangents dy and dstate; returned on the kernel's."""
    bh, s, p = xdt.shape
    n = bg.shape[-1]
    r = bh // (bsz * g)

    def grouped(v, shape):
        return jnp.asarray(v.numpy().reshape(shape), dtype)

    args = (grouped(xdt, (bsz, g, r, s, p)),
            jnp.asarray(la.numpy().reshape(bsz, g, r, s)),
            grouped(bg, (bsz, g, s, n)), grouped(cg, (bsz, g, s, n)))
    dyj = jnp.asarray(dy.numpy().reshape(bsz, g, r, s, p), jnp.float32)
    dsj = None if dstate is None else \
        jnp.asarray(dstate.numpy().reshape(bsz, g, r, p, n))

    def loss(xd, lv, bv, cv):
        y, st = jax_grouped(xd, lv, bv, cv, chunk=chunk)
        out = jnp.sum(y.astype(jnp.float32) * dyj)
        return out if dsj is None else out + jnp.sum(st * dsj)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    shapes = ((bh, s, p), (bh, s), (bsz * g, s, n), (bsz * g, s, n))
    return [np.asarray(gv, np.float32).reshape(sh)
            for gv, sh in zip(grads, shapes, strict=True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("bsz,s,h,p,g,n,chunk", CASES)
def test_bwd_plain_matches_jax_grad_of_the_grouped_scan(bsz, s, h, p, g, n,
                                                        chunk, with_dstate,
                                                        dtype):
    """dxdt, dla, dB and dC against ``jax.grad`` of the reference's grouped
    chunked scan on the same values.  bf16: xdt, B, C and dy rounded to
    bf16, and the reference's gradient taken in f32 on those values, as the
    port takes it (the reference's bf16 route rounds its cotangents to
    bf16: see the next test)."""
    xdt, la, bg, cg, dy, dstate = _flat(*_draw(bsz, s, h, p, g, n, 1))
    xdt, bg, cg, dy = (t.to(dtype) for t in (xdt, bg, cg, dy))
    dstate = dstate if with_dstate else None
    got = ssd_scan_bwd_plain(xdt, la, bg, cg, dy, dstate, chunk=chunk,
                             rep=h // g)
    assert [t.dtype for t in got] == [dtype, torch.float32, dtype, dtype]
    want = _jax_grouped_grads(xdt.float(), la, bg.float(), cg.float(),
                              dy.float(), dstate, bsz, g, chunk, jnp.float32)
    for name, gv, wv in zip(NAMES, got, want, strict=True):
        _close(gv.float(), wv, _tol(dtype), name)


def test_reference_bf16_gradient_leaves_its_f32_gradient():
    """Why the bf16 cases hold against the reference's f32 gradient: at the
    reference test's first shape (rep 2, chunk 32) its bf16 route's dxdt
    and dla miss its own f32 gradient on the same bf16 values by more than
    the bf16 tolerance (its einsums' cotangents are rounded to bf16), where
    the port's bf16 gradient holds it."""
    bsz, s, h, p, g, n, chunk = CASES[0]
    xdt, la, bg, cg, dy, _ = _flat(*_draw(bsz, s, h, p, g, n, 1))
    xdt, bg, cg, dy = (t.to(torch.bfloat16) for t in (xdt, bg, cg, dy))
    args = (xdt.float(), la, bg.float(), cg.float(), dy.float(), None, bsz,
            g, chunk)
    f32 = _jax_grouped_grads(*args, jnp.float32)
    bf16 = _jax_grouped_grads(*args, jnp.bfloat16)
    port = ssd_scan_bwd_plain(xdt, la, bg, cg, dy, None, chunk=chunk,
                              rep=h // g)
    for name, pv, bv, fv in zip(NAMES, port, bf16, f32, strict=True):
        _close(pv.float(), fv, BF16_TOL, name)
        if name in ("dxdt", "dla"):
            with pytest.raises(AssertionError):
                _close(bv, fv, BF16_TOL, name)


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("bsz,s,h,p,g,n,chunk", CASES)
def test_kernel_route_grads_match_jax_grad_of_the_reference_ssd(
        bsz, s, h, p, g, n, chunk, with_dstate):
    """The port's ``ssd`` on the kernel route (``_SSDScan``, whose CPU
    backward is ``ssd_scan_bwd_plain``) against ``jax.grad`` of the
    reference's ``ops.ssd(..., use_pallas=False)`` in f32: the gradients of
    x, dt, B and C through the D skip, against the same cotangents of y and
    the final state.  (In bf16 the chain rule's own products and sums
    round: dt's gradient, a sum over P that cancels, leaves the f32 one by
    more than the bf16 tolerance on both packages; the bf16 scan gradient
    is held in the grouped-scan test above.)"""
    x, dt, a, bm, cm, dy, dstate = _draw(bsz, s, h, p, g, n, 2)
    d = np.random.default_rng(3).standard_normal(h).astype(np.float32)
    ds = dstate if with_dstate else np.zeros_like(dstate)

    def jloss(xv, dtv, bv, cv):
        y, st = jax_ssd(xv, dtv, jnp.asarray(a), bv, cv, jnp.asarray(d),
                        chunk=chunk, use_pallas=False)
        return jnp.sum(y * jnp.asarray(dy)) + jnp.sum(st * jnp.asarray(ds))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (x, dt, bm, cm)))
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (x, dt, bm, cm)]
    before = dict(k5.LAUNCHES)
    y, st = ssd(leaves[0], leaves[1], torch.from_numpy(a), leaves[2],
                leaves[3], torch.from_numpy(d), chunk=chunk, use_pallas=True)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_dstate:
        loss = loss + (st * torch.from_numpy(ds)).sum()
    loss.backward()
    assert k5.LAUNCHES == before      # the CPU runs the plain versions
    for name, leaf, wv in zip(("dx", "ddt", "db", "dc"), leaves, want,
                              strict=True):
        _close(leaf.grad, np.asarray(wv), F32_TOL, name)


def _recurrence_f64_grads(xdt, la, bg, cg, dy, dstate, rep):
    """Autograd through the sequential recurrence (``ssd_scan_ref``) all in
    f64: the gradients of (xdt, la, b, c) against dy and dstate."""
    leaves = [t.double().requires_grad_(True) for t in (xdt, la, bg, cg)]
    y, h = ssd_scan_ref(leaves[0], leaves[1],
                        *(torch.repeat_interleave(t, rep, 0)
                          for t in leaves[2:]))
    loss = (y * dy.double()).sum()
    if dstate is not None:
        loss = loss + (h * dstate.double()).sum()
    loss.backward()
    return [t.grad for t in leaves]


def _rel(got, want):
    """Relative Frobenius error of ``got`` against ``want`` (f64)."""
    want = torch.as_tensor(np.asarray(want), dtype=torch.float64)
    got = torch.as_tensor(np.asarray(got, np.float64), dtype=torch.float64)
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("la_floor", [-1.0, -5.0, -50.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_bwd_plain_matches_the_f64_recurrence_at_steep_decays(seed,
                                                              la_floor):
    """The steepest la a step down to -50, at Mamba2's head width and state
    (P 64, N 128), S 300 in chunks of 256 (a ragged last chunk), one group
    of 4 heads, with the final state's gradient: each of the plain
    backward's gradients within 1e-4 of the f64 recurrence's, as a relative
    Frobenius error (measured: 1e-6 to 2.1e-5; the reference's f32 route,
    1e-6 to 1.6e-5).  Elementwise the f32 chunked algorithm misses the f64
    recurrence past the f32 tolerance from la -1 on, in both packages: a
    decay exp(cum_i - cum_j) carries the rounding of prefix sums in the
    thousands, and some sums of such terms cancel."""
    xdt, la, bg, cg, dy, dstate = _flat(
        *_draw(1, 300, 4, 64, 1, 128, seed, la_floor=la_floor))
    got = ssd_scan_bwd_plain(xdt, la, bg, cg, dy, dstate, chunk=256, rep=4)
    want = _recurrence_f64_grads(xdt, la, bg, cg, dy, dstate, 4)
    errs = {name: _rel(gv, wv) for name, gv, wv in zip(NAMES, got, want,
                                                       strict=True)}
    assert max(errs.values()) <= 1e-4, errs


def test_suffix_sum_is_the_transpose_of_the_prefix_sum():
    d = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 37)).astype(np.float32))
    want = torch.flip(torch.cumsum(torch.flip(d.double(), [-1]), -1), [-1])
    assert torch.equal(suffix_sum(d), want.float())
    la = torch.zeros((3, 37), requires_grad=True)
    (torch.cumsum(la.double(), -1).float() * d).sum().backward()
    torch.testing.assert_close(la.grad, suffix_sum(d))
