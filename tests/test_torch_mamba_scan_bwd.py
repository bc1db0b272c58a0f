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
    prefix_sum,
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


# ------------------------------ K5's backward kernels, their decomposition
# A plain-torch model of what the backward kernels of csrc/mamba_scan.cu
# compute, in their order (the chunked algorithm of the Mamba-2 paper
# applied to the gradient):
#   1. per chunk (``ssd_bwd_sums_*``): cum (``prefix_sum``), the chunk's
#      own state sum hc = (x ⊙ w)ᵀ B and its dy-side sum gc = (dy ⊙
#      e^{cum})ᵀ C;
#   2. state passing (``ssd_bwd_pass_kernel``): h_in(z+1) = e^{cum_L(z)}
#      h_in(z) + hc_z from 0, dh(z-1) = e^{cum_L(z)} dh(z) + gc_z from
#      dstate (or 0), and <dh(z), h_in(z)> in f32;
#   3. per chunk and 64-row tile (``ssd_bwd_local_*``): each E = (G ⊙ W) ⊙
#      M tile formed once, its row sums over the keys of each key tile J
#      and its column sums over the queries, both in f64 from the one f32
#      value; dx, dB (per head) with the state terms w_j dh B_j, w_j dhᵀ
#      x_j and r_j = w_j x_jᵀ dh B_j; dC (per head) with e^{cum_i} h_inᵀ
#      dy_i and inter_i = e^{cum_i} C_i · h_inᵀ dy_i;
#   4. dla (``ssd_bwd_dla_kernel``): dcum_i = (Σ_J erow_iJ, J in order) -
#      ecol_i + inter_i - r_i in f64, dcum_L += e^{cum_L} <dh, h_in> + Σ_j
#      r_j, and the suffix sum (``suffix_sum``);
#   5. dB and dC summed over each group's heads in f32, rounded once.
# ``rnd`` maps the f32 operands the bf16 kernel takes as bf16 terms to
# their rounding: "s" (G ⊙ W, dx's), "q" (M ⊙ W, dB's and dC's), "xw" (x ⊙
# w, hc's), "dye" (dy ⊙ e^{cum}, gc's), "dh" and "h" (h_in); absent, f32.
# The bf16 kernel takes B, C, xdt and dy as they come (bf16, exact) and
# sums every product in f32.
K5_BWD_TILE = 64


def _decomposed_bwd(xdt, la, b, c, dy, dstate, *, chunk, rep, rnd=None):
    rnd = rnd or {}

    def r(name, v):
        return rnd[name](v) if name in rnd else v

    bh, s, p = xdt.shape
    n = b.shape[-1]
    bm_all = torch.repeat_interleave(b, rep, 0).float()
    cm_all = torch.repeat_interleave(c, rep, 0).float()
    sls = [slice(c0, min(c0 + chunk, s)) for c0 in range(0, s, chunk)]
    nc = len(sls)
    cums = [prefix_sum(la[:, sl].float()) for sl in sls]
    el = [torch.exp(cm[:, -1])[:, None, None] for cm in cums]
    hc, gc = [], []
    for sl, cum in zip(sls, cums, strict=True):
        w = torch.exp(cum[:, -1:] - cum)[..., None]
        ec = torch.exp(cum)[..., None]
        hc.append(r("xw", xdt[:, sl].float() * w).transpose(1, 2)
                  @ bm_all[:, sl])
        gc.append(r("dye", dy[:, sl].float() * ec).transpose(1, 2)
                  @ cm_all[:, sl])
    h_in = [torch.zeros((bh, p, n))]
    for z in range(nc - 1):
        h_in.append(el[z] * h_in[-1] + hc[z])
    dh = [None] * nc
    dh[-1] = torch.zeros((bh, p, n)) if dstate is None else dstate.float()
    for z in range(nc - 1, 0, -1):
        dh[z - 1] = el[z] * dh[z] + gc[z]
    dx = torch.empty((bh, s, p))
    dla = torch.empty((bh, s))
    db = torch.empty((bh, s, n))
    dc = torch.empty((bh, s, n))
    for z, (sl, cum) in enumerate(zip(sls, cums, strict=True)):
        x, dyc = xdt[:, sl].float(), dy[:, sl].float()
        bm, cm = bm_all[:, sl], cm_all[:, sl]
        ln = cum.shape[1]
        mask = torch.ones((ln, ln), dtype=torch.bool).tril()
        wm = torch.where(mask, torch.exp(torch.clamp_max(
            cum[:, :, None] - cum[:, None, :], 0.0)), 0.0)
        mmat = dyc @ x.transpose(1, 2)
        smat = (cm @ bm.transpose(1, 2)) * wm
        qmat = mmat * wm
        e64 = (smat * mmat).double()
        w = torch.exp(cum[:, -1:] - cum)
        ec = torch.exp(cum)
        v = bm @ r("dh", dh[z]).transpose(1, 2)
        rj = w * (x * v).sum(-1)
        u = dyc @ r("h", h_in[z])
        inter = ec * (cm * u).sum(-1)
        dx[:, sl] = w[..., None] * v + r("s", smat).transpose(1, 2) @ dyc
        db[:, sl] = w[..., None] * (x @ r("dh", dh[z])) \
            + r("q", qmat).transpose(1, 2) @ cm
        dc[:, sl] = ec[..., None] * u + r("q", qmat) @ bm
        dcum = torch.zeros((bh, ln), dtype=torch.float64)
        for j0 in range(0, ln, K5_BWD_TILE):
            dcum += e64[:, :, j0:j0 + K5_BWD_TILE].sum(-1)
        dcum = dcum - e64.sum(-2) + inter.double() - rj.double()
        dot = (dh[z] * h_in[z]).sum((-2, -1))
        dcum[:, -1] += (el[z][:, 0, 0] * dot).double() + rj.double().sum(-1)
        dla[:, sl] = suffix_sum(dcum)
    if rep > 1:
        db = db.reshape(bh // rep, rep, s, n).sum(1)
        dc = dc.reshape(bh // rep, rep, s, n).sum(1)
    return dx.to(xdt.dtype), dla, db.to(b.dtype), dc.to(c.dtype)


# CASES and several chunk counts: 5 chunks of 64 with a ragged last one at
# Mamba2's head width and state.
K5_BWD_MODEL_CASES = CASES + [(1, 300, 4, 64, 1, 128, 64)]


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("bsz,s,h,p,g,n,chunk", K5_BWD_MODEL_CASES)
def test_k5_bwd_decomposition_matches_the_plain_backward(bsz, s, h, p, g, n,
                                                         chunk, with_dstate):
    """The kernels' decomposition, in f32, against ``ssd_scan_bwd_plain``
    (what the kernels are held against on the card) at the f32
    tolerance."""
    xdt, la, bg, cg, dy, dstate = _flat(*_draw(bsz, s, h, p, g, n, 5))
    dstate = dstate if with_dstate else None
    got = _decomposed_bwd(xdt, la, bg, cg, dy, dstate, chunk=chunk,
                          rep=h // g)
    want = ssd_scan_bwd_plain(xdt, la, bg, cg, dy, dstate, chunk=chunk,
                              rep=h // g)
    for name, gv, wv in zip(NAMES, got, want, strict=True):
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
        _close(gv, wv, F32_TOL, name)


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("bsz,s,h,p,g,n,chunk", K5_BWD_MODEL_CASES)
def test_k5_bwd_decomposition_matches_jax_grad_of_the_grouped_scan(
        bsz, s, h, p, g, n, chunk, with_dstate):
    """The same decomposition against ``jax.grad`` of the reference's
    grouped chunked scan on the same numpy inputs, at the f32 tolerance."""
    xdt, la, bg, cg, dy, dstate = _flat(*_draw(bsz, s, h, p, g, n, 6))
    dstate = dstate if with_dstate else None
    got = _decomposed_bwd(xdt, la, bg, cg, dy, dstate, chunk=chunk,
                          rep=h // g)
    want = _jax_grouped_grads(xdt, la, bg, cg, dy, dstate, bsz, g, chunk,
                              jnp.float32)
    for name, gv, wv in zip(NAMES, got, want, strict=True):
        _close(gv, wv, F32_TOL, name)


def _split(v):
    """v as two bf16 terms summed in f32: hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def _once(v):
    return v.to(torch.bfloat16).float()


#: The f32 operands the bf16 kernels take as hi + lo bf16 terms.
K5_BWD_SPLIT = ("s", "q", "xw", "dye", "dh", "h")


def _k5_bwd_bf16_case(s, la_floor, seed):
    """Mamba2-2.7B's widths on 8 heads of one group (P 64, N 128; S cut for
    the CPU), xdt, B, C and dy in bf16, with the final state's gradient."""
    xdt, la, bg, cg, dy, dstate = _flat(
        *_draw(1, s, 8, 64, 1, 128, seed, la_floor=la_floor))
    xdt, bg, cg, dy = (t.to(torch.bfloat16) for t in (xdt, bg, cg, dy))
    return xdt, la, bg, cg, dy, dstate


def _bf16_margin(got, want):
    """Max over the four gradients and their elements of |got - want| -
    (atol + rtol |want|) at the bf16 tolerance: <= 0 within it."""
    worst = -float("inf")
    for gv, wv in zip(got, want, strict=True):
        wv = (wv if isinstance(wv, torch.Tensor)
              else torch.from_numpy(np.array(wv, np.float32))).float()
        worst = max(worst, float(((gv.float() - wv).abs() - (
            BF16_TOL["atol"] + BF16_TOL["rtol"] * wv.abs())).max()))
    return worst


@pytest.mark.parametrize("s,la_floor,seed", [(768, None, 0), (768, -50.0, 1),
                                             (600, None, 2)])
def test_k5_bwd_bf16_model_matches_reference_f32_gradient(s, la_floor, seed):
    """The bf16 kernels' rounding (bf16 operands, the f32-kept ones as hi +
    lo, f32 sums) within the bf16 tolerance of ``jax.grad`` of the
    reference's grouped scan taken in f32 on the same bf16 values, and of
    the plain backward, at chunk 256 (S 600: a ragged last chunk)."""
    xdt, la, bg, cg, dy, dstate = _k5_bwd_bf16_case(s, la_floor, seed)
    got = _decomposed_bwd(xdt, la, bg, cg, dy, dstate, chunk=256, rep=8,
                          rnd={k: _split for k in K5_BWD_SPLIT})
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    assert all(torch.isfinite(t.float()).all() for t in got)
    want = _jax_grouped_grads(xdt.float(), la, bg.float(), cg.float(),
                              dy.float(), dstate, 1, 1, 256, jnp.float32)
    assert _bf16_margin(got, want) <= 0
    plain = ssd_scan_bwd_plain(xdt, la, bg, cg, dy, dstate, chunk=256, rep=8)
    assert _bf16_margin(got, plain) <= 0


@pytest.mark.parametrize("operand", K5_BWD_SPLIT)
def test_k5_bwd_takes_each_f32_operand_as_hi_plus_lo(operand):
    """Why the bf16 kernels split each f32 operand into hi + lo: rounded
    to bf16 once (the others split), each puts Mamba2's widths outside the
    bf16 tolerance of the plain backward for some of seeds 0-2, with the
    reference test's decays or with la down to -50 a step, where the
    kernels' rounding stays inside for all of them."""
    split = {k: _split for k in K5_BWD_SPLIT}
    worst_once = worst_split = -1.0
    for la_floor in (None, -50.0):
        for seed in range(3):
            case = _k5_bwd_bf16_case(768, la_floor, seed)
            want = ssd_scan_bwd_plain(*case, chunk=256, rep=8)
            worst_once = max(worst_once, _bf16_margin(_decomposed_bwd(
                *case, chunk=256, rep=8, rnd=dict(split, **{
                    operand: _once})), want))
            worst_split = max(worst_split, _bf16_margin(_decomposed_bwd(
                *case, chunk=256, rep=8, rnd=split), want))
    assert worst_once > 0 >= worst_split, (worst_once, worst_split)
