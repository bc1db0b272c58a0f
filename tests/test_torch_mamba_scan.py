"""Port parity: the SSD scan (``repro_torch.kernels.mamba_scan``) against the
JAX package's on the same numpy inputs, on the CPU.

Mirrors ``tests/test_kernels.py``'s SSD cases: the port's ``ssd`` on the
plain grouped path (``use_pallas=False``) against the reference's, and on
the kernel route (``use_pallas=True``: K5's wrapper, which takes its plain
version on the CPU) against the reference's Pallas kernel in interpret
mode; both shapes in f32 and bf16, chunk invariance, a non-divisible S,
the ``h0`` continuation and the ``dt x 100`` decay stability.  K5's plain
version and the sequential oracle are held against the reference's
``ssd_scan(interpret=True)`` and ``ssd_scan_ref``.  A plain-torch model
of K5's bf16 tensor-core arithmetic is held against the reference's
chunked scan and Pallas kernel, and shows which of its f32 operands must
enter the bf16 products as two terms; a model of K5's f32 kernel (one FMA
chain an output) is held against both at the f32 tolerance, and shows why
its products stay off the tensor cores.  Tolerances are the reference's
(``tests/test_kernels.py:20-23``): f32 rtol 5e-4 / atol 5e-5, bf16 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.mamba_scan import ssd_scan as jax_ssd_scan
from repro.kernels.mamba_scan.ops import ssd as jax_ssd
from repro.kernels.mamba_scan.ops import ssd_chunked_jnp
from repro.kernels.mamba_scan.ref import ssd_scan_ref as jax_scan_ref
from repro_torch.kernels.mamba_scan import mamba_scan as k5
from repro_torch.kernels.mamba_scan.ops import ssd, ssd_chunked
from repro_torch.kernels.mamba_scan.ref import (
    prefix_sum,
    ssd_scan_plain,
    ssd_scan_ref,
)
from repro_torch.models.bridge import tensor_from_numpy

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

SHAPES = [(2, 96, 4, 16, 2, 8), (1, 64, 2, 8, 1, 16)]


def _tol(dtype):
    # The reference's own tolerances (tests/test_kernels.py:20-23).
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else \
        dict(rtol=5e-4, atol=5e-5)


def _close(out, ref, dtype):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), **_tol(dtype))


def _t(arr) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(arr), "cpu")


def _inputs(b, s, h, p, g, n, dtype=jnp.float32, seed=0):
    """The reference test's inputs (``_ssd_inputs``), as JAX arrays and as
    the same values in torch tensors."""
    r = np.random.default_rng(seed)
    j = (
        jnp.asarray(r.standard_normal((b, s, h, p)), dtype),
        jnp.asarray(np.abs(r.standard_normal((b, s, h))) * 0.1 + 0.01, dtype),
        jnp.asarray(-np.abs(r.standard_normal(h)) - 0.1, jnp.float32),
        jnp.asarray(r.standard_normal((b, s, g, n)), dtype),
        jnp.asarray(r.standard_normal((b, s, g, n)), dtype),
        jnp.asarray(r.standard_normal(h), jnp.float32),
    )
    return j, tuple(_t(x) for x in j)


def _flat(x, dt, a, bm, cm):
    """(xdt, la, b, c) of the kernel's (BH, S, .) layout, B and C repeated
    per head (torch tensors)."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    rep = h // g
    xdt = (x * dt[..., None]).transpose(1, 2).reshape(b * h, s, p)
    la = (dt * a[None, None, :]).transpose(1, 2).reshape(b * h, s)
    bf = torch.repeat_interleave(bm, rep, 2).transpose(1, 2).reshape(b * h, s, n)
    cf = torch.repeat_interleave(cm, rep, 2).transpose(1, 2).reshape(b * h, s, n)
    return xdt, la, bf, cf


def _gold(x, dt, a, bm, cm, d):
    """The port's sequential oracle with the D skip: (y, state)."""
    b, s, h, p = x.shape
    n = bm.shape[3]
    y, hf = ssd_scan_ref(*_flat(x, dt, a, bm, cm))
    y = y.reshape(b, h, s, p).transpose(1, 2) + x * d[None, None, :, None]
    return y, hf.reshape(b, h, p, n)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("b,s,h,p,g,n", SHAPES)
def test_ssd_matches_reference_and_naive_scan(b, s, h, p, g, n, use_pallas,
                                              dtype):
    jin, tin = _inputs(b, s, h, p, g, n, dtype)
    jy, jh = jax_ssd(*jin, chunk=32, use_pallas=use_pallas,
                     interpret=True if use_pallas else None)
    y, hf = ssd(*tin, chunk=32, use_pallas=use_pallas)
    assert y.dtype == tin[0].dtype and hf.dtype == torch.float32
    assert tuple(y.shape) == (b, s, h, p) and tuple(hf.shape) == (b, h, p, n)
    _close(y, jy, dtype)
    _close(hf, jh, dtype)
    gy, gh = _gold(*tin)
    _close(y, gy.float().numpy(), dtype)
    _close(hf, gh.numpy(), dtype)


@pytest.mark.parametrize("chunk", [16, 32, 64, 96])
def test_ssd_chunk_size_invariance(chunk):
    jin, tin = _inputs(1, 96, 2, 8, 1, 4)
    jy, _ = jax_ssd(*jin, chunk=chunk, use_pallas=True, interpret=True)
    y, _ = ssd(*tin, chunk=chunk, use_pallas=True)
    _close(y, jy, jnp.float32)
    _close(y, _gold(*tin)[0].numpy(), jnp.float32)
    yp, _ = ssd(*tin, chunk=chunk, use_pallas=False)
    _close(yp, jy, jnp.float32)


def test_ssd_nondivisible_seq():
    """S = 90 with chunk 32: the reference pads with la = 0, xdt = 0; K5's
    plain version takes the short last chunk as it is."""
    jin, tin = _inputs(1, 90, 2, 8, 1, 4)
    jy, jh = jax_ssd(*jin, chunk=32, use_pallas=True, interpret=True)
    for use_pallas in (True, False):
        y, hf = ssd(*tin, chunk=32, use_pallas=use_pallas)
        _close(y, jy, jnp.float32)
        _close(hf, jh, jnp.float32)
        _close(y, _gold(*tin)[0].numpy(), jnp.float32)


def test_ssd_state_continuation():
    """Splitting a sequence and carrying h0 equals the unsplit scan, and
    the reference's split run."""
    jin, tin = _inputs(1, 64, 2, 8, 1, 4)
    x, dt, a, bm, cm, d = tin
    gy, gh = _gold(*tin)
    y1, h1 = ssd(x[:, :32], dt[:, :32], a, bm[:, :32], cm[:, :32], d,
                 chunk=16, use_pallas=False)
    y2, h2 = ssd(x[:, 32:], dt[:, 32:], a, bm[:, 32:], cm[:, 32:], d,
                 chunk=16, use_pallas=False, h0=h1)
    _close(torch.cat([y1, y2], dim=1), gy.numpy(), jnp.float32)
    _close(h2, gh.numpy(), jnp.float32)
    jx, jdt, ja, jb, jc, jd = jin
    _, jh1 = jax_ssd(jx[:, :32], jdt[:, :32], ja, jb[:, :32], jc[:, :32], jd,
                     chunk=16, use_pallas=False)
    jy2, jh2 = jax_ssd(jx[:, 32:], jdt[:, 32:], ja, jb[:, 32:], jc[:, 32:],
                       jd, chunk=16, use_pallas=False, h0=jh1)
    _close(y2, jy2, jnp.float32)
    _close(h2, jh2, jnp.float32)


def test_kernel_route_with_h0_raises_as_reference():
    jin, tin = _inputs(1, 32, 2, 8, 1, 4)
    h0 = torch.zeros((1, 2, 8, 4))
    with pytest.raises(NotImplementedError, match="zero state"):
        ssd(*tin, chunk=16, use_pallas=True, h0=h0)
    with pytest.raises(NotImplementedError, match="zero state"):
        jax_ssd(*jin, chunk=16, use_pallas=True, interpret=True,
                h0=jnp.zeros((1, 2, 8, 4)))


@pytest.mark.parametrize("seed", [0, 3, 2**31])
@pytest.mark.parametrize("s", [33, 48, 64, 100])
def test_ssd_property_chunked_equals_sequential(s, seed):
    jin, tin = _inputs(1, s, 2, 8, 2, 4, seed=seed)
    y, _ = ssd(*tin, chunk=32, use_pallas=False)
    _close(y, _gold(*tin)[0].numpy(), jnp.float32)
    yk, _ = ssd(*tin, chunk=32, use_pallas=True)
    _close(yk, y.numpy(), jnp.float32)
    jy, _ = jax_ssd(*jin, chunk=32, use_pallas=False)
    _close(y, jy, jnp.float32)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_ssd_decay_stability(use_pallas):
    """Long sequences with strong decay stay finite, as in the reference."""
    _, (x, dt, a, bm, cm, d) = _inputs(1, 256, 2, 8, 1, 4)
    y, h = ssd(x, dt * 100.0, a, bm, cm, d, chunk=64, use_pallas=use_pallas)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n", SHAPES)
def test_plain_k5_and_oracle_match_reference_kernel(b, s, h, p, g, n, dtype):
    """K5's plain version against the reference's Pallas ``ssd_scan`` in
    interpret mode, and the sequential oracles against each other, on the
    kernel's (B*H, S, .) layout."""
    _, tin = _inputs(b, s, h, p, g, n, dtype)
    xdt, la, bf, cf = _flat(*tin[:5])
    j = [jnp.asarray(np.asarray(t.float()), dtype) for t in (xdt, bf, cf)]
    jla = jnp.asarray(la.numpy())
    jy, jh = jax_ssd_scan(j[0], jla, j[1], j[2], chunk=32, interpret=True)
    y, hf = ssd_scan_plain(xdt, la, bf, cf, chunk=32)
    assert y.dtype == xdt.dtype and hf.dtype == torch.float32
    _close(y, jy, dtype)
    _close(hf, jh, dtype)
    ry, rh = jax_scan_ref(j[0], jla, j[1], j[2])
    gy, gh = ssd_scan_ref(xdt, la, bf, cf)
    assert gy.dtype == xdt.dtype
    _close(gy, ry, dtype)
    _close(gh, rh, dtype)


def test_k5_wrapper_reads_b_c_per_group_on_the_cpu():
    """``rep`` > 1: the wrapper's grouped B/C give the same result as the
    repeated rows, and ``chunk`` need not divide S."""
    _, (x, dt, a, bm, cm, _) = _inputs(2, 40, 4, 8, 2, 4)
    xdt, la, bf, cf = _flat(x, dt, a, bm, cm)
    bg = bm.transpose(1, 2).reshape(4, 40, 4)
    cg = cm.transpose(1, 2).reshape(4, 40, 4)
    before = dict(k5.LAUNCHES)
    y, hf = k5.ssd_scan(xdt, la, bg, cg, chunk=16, rep=2)
    ry, rh = ssd_scan_plain(xdt, la, bf, cf, chunk=16)
    assert torch.equal(y, ry) and torch.equal(hf, rh)
    assert k5.LAUNCHES == before            # the plain version is no launch
    with pytest.raises(ValueError, match="rep"):
        k5.ssd_scan(xdt, la, bg, cg, rep=3)


def test_ssd_chunked_matches_reference():
    jin, tin = _inputs(2, 50, 2, 8, 1, 4)
    xdt, la, bf, cf = _flat(*tin[:5])
    h0 = torch.as_tensor(np.random.default_rng(5).standard_normal((4, 8, 4)),
                         dtype=torch.float32)
    y, hf = ssd_chunked(xdt, la, bf, cf, chunk=16, h0=h0)
    jy, jh = ssd_chunked_jnp(*(jnp.asarray(t.numpy()) for t in (xdt, la, bf, cf)),
                             chunk=16, h0=jnp.asarray(h0.numpy()))
    _close(y, jy, jnp.float32)
    _close(hf, jh, jnp.float32)


def test_chunk_none_takes_the_fallback():
    """An unswept shape bucket keeps the built-in chunk of 128."""
    _, tin = _inputs(1, 200, 2, 8, 1, 4)
    for use_pallas in (True, False):
        y, hf = ssd(*tin, chunk=None, use_pallas=use_pallas)
        y128, h128 = ssd(*tin, chunk=128, use_pallas=use_pallas)
        assert torch.equal(y, y128) and torch.equal(hf, h128)


# ------------------------------------------ K5's bf16 kernel, its rounding
# A plain-torch model of the arithmetic of K5's bf16 kernel
# (csrc/mamba_scan.cu, ``ssd_scan_mma_kernel``): every product has bf16
# operands and an f32 sum; B, C and xdt arrive in bf16, so the Gram C Bᵀ
# and the xdt operand are exact; the three f32 operands, the decayed scores
# S, xdt ⊙ exp(cum_last - cum) and the carried state h0, enter as two bf16
# terms (hi = bf16(v), lo = bf16(v - hi)).  Per chunk: y = exp(cum) (C
# h0ᵀ) first, then S xdt over 64-key tiles; h = exp(cum_last) h0, then (xdt
# w)ᵀ B over 64-key tiles.  The prefix sum is ``prefix_sum``'s.
K5_TOL = dict(rtol=2e-2, atol=2e-2)


def _split(v):
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def _once(v):
    return v.to(torch.bfloat16).float()


def _k5_bf16_model(xdt, la, b, c, *, chunk, round_s=_split,
                   round_xw=_split, round_h=_split):
    """(y in bf16, state f32) as K5's bf16 kernel forms them, on the
    (BH, S, .) layout with B and C per head."""
    bh, s, p = xdt.shape
    h = torch.zeros((bh, p, b.shape[-1]))
    y = torch.empty((bh, s, p))
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        x, bm, cm = xdt[:, sl].float(), b[:, sl].float(), c[:, sl].float()
        cum = prefix_sum(la[:, sl].float())
        n_c = cum.shape[1]
        causal = torch.ones((n_c, n_c), dtype=torch.bool).tril()
        scores = torch.where(causal, (cm @ bm.transpose(1, 2)) * torch.exp(
            torch.clamp_max(cum[:, :, None] - cum[:, None, :], 0.0)), 0.0)
        yc = torch.exp(cum)[..., None] * (cm @ round_h(h).transpose(1, 2))
        xw = x * torch.exp(cum[:, -1:] - cum)[..., None]
        h = torch.exp(cum[:, -1])[:, None, None] * h
        for j0 in range(0, n_c, 64):
            kt = slice(j0, j0 + 64)
            yc = yc + round_s(scores[:, :, kt]) @ x[:, kt]
            h = h + round_xw(xw[:, kt]).transpose(1, 2) @ bm[:, kt]
        y[:, sl] = yc
    return y.to(xdt.dtype), h


def _k5_case(bh, s, p, n, seed, la_floor=None, dtype=torch.bfloat16,
             exact_cum=False):
    """(xdt, la, b, c) on the kernel's layout, xdt, b and c in ``dtype``,
    drawn as the reference test draws them (``_inputs``); with ``la_floor``
    dt is scaled so that the steepest step's la = dt A is ``la_floor``.
    ``exact_cum`` rounds la to a multiple of 2^-8, so that every prefix sum
    (at most 512 x 50 < 2^15 in size) is exact in f32 whatever the order of
    its adds."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((bh, s, p)).astype(np.float32)
    dt = (np.abs(r.standard_normal((bh, s))) * 0.1 + 0.01).astype(
        np.float32)
    a = (-np.abs(r.standard_normal(bh)) - 0.1).astype(np.float32)
    if la_floor is not None:
        dt *= np.float32(la_floor / (dt * a[:, None]).min())
    bc = [torch.from_numpy(r.standard_normal((bh, s, n)).astype(
        np.float32)).to(dtype) for _ in range(2)]
    xdt = torch.from_numpy(x * dt[..., None]).to(dtype)
    la = dt * a[:, None]
    if exact_cum:
        la = np.round(la * 256) / 256
    return xdt, torch.from_numpy(la), bc[0], bc[1]


def _jax_chunked(xdt, la, b, c, chunk):
    """The reference's chunked scan in f32 on the same values: (y rounded
    to xdt's dtype, state)."""
    jy, jh = ssd_chunked_jnp(*(jnp.asarray(t.float().numpy()) for t in
                               (xdt, la, b, c)), chunk=chunk)
    return (torch.from_numpy(np.array(jy)).to(xdt.dtype),
            torch.from_numpy(np.array(jh)))


def _k5_margin(got, want, tol=K5_TOL):
    """Max over both outputs and their elements of |got - want| - (atol +
    rtol |want|): <= 0 within the tolerance (by default bf16's)."""
    return max(float(((g.float() - w.float()).abs() - (
        tol["atol"] + tol["rtol"] * w.float().abs())).max())
        for g, w in zip(got, want, strict=True))


# (bh, s, p, n, chunk, la_floor): the reference's kernel-test shapes, the
# serving path's chunk of 256 at S = 512 with P 64 and N 128 (4 heads), a
# short last chunk, and la down to -50 a step.
K5_MODEL_CASES = [(8, 96, 16, 8, 32, None), (2, 64, 8, 16, 32, None),
                  (4, 512, 64, 128, 256, None), (4, 512, 64, 128, 256, -50.0),
                  (4, 300, 64, 128, 256, None), (4, 300, 64, 128, 256, -50.0)]


@pytest.mark.parametrize("bh,s,p,n,chunk,la_floor", K5_MODEL_CASES)
def test_k5_bf16_model_matches_reference_chunked_scan(bh, s, p, n, chunk,
                                                      la_floor):
    xdt, la, b, c = _k5_case(bh, s, p, n, 0, la_floor)
    got = _k5_bf16_model(xdt, la, b, c, chunk=chunk)
    assert got[0].dtype == torch.bfloat16 and torch.isfinite(
        got[0].float()).all()
    assert _k5_margin(got, _jax_chunked(xdt, la, b, c, chunk)) <= 0
    # And the port's plain version, which the card holds K5 against.
    assert _k5_margin(got, ssd_scan_plain(xdt, la, b, c, chunk=chunk)) <= 0


@pytest.mark.parametrize("la_floor", [None, -50.0])
def test_k5_bf16_model_matches_reference_pallas_kernel(la_floor):
    """Against the reference's Pallas ``_ssd_kernel`` in interpret mode at
    chunk 256, S = 512, P 64, N 128."""
    xdt, la, b, c = _k5_case(2, 512, 64, 128, 1, la_floor)
    jy, jh = jax_ssd_scan(*(jnp.asarray(t.float().numpy()) for t in
                            (xdt, la, b, c)), chunk=256, interpret=True)
    want = (torch.from_numpy(np.array(jy)).to(torch.bfloat16),
            torch.from_numpy(np.array(jh)))
    assert _k5_margin(_k5_bf16_model(xdt, la, b, c, chunk=256), want) <= 0


@pytest.mark.parametrize("operand", ["scores", "xdt_w", "h0"])
def test_k5_takes_each_f32_operand_as_hi_plus_lo(operand):
    """Why K5's bf16 kernel splits S, xdt ⊙ w and h0 into hi + lo: each
    rounded to bf16 once (the others split) puts the serving path's shape
    outside the bf16 tolerance for some of seeds 0-2, with the reference
    test's decays or with la down to -50 a step, where the kernel's
    rounding stays inside for all of them."""
    once = {"scores": dict(round_s=_once), "xdt_w": dict(round_xw=_once),
            "h0": dict(round_h=_once)}[operand]
    worst_once = worst_split = -1.0
    for la_floor in (None, -50.0):
        for seed in range(3):
            xdt, la, b, c = _k5_case(8, 512, 64, 128, seed, la_floor)
            want = _jax_chunked(xdt, la, b, c, 256)
            worst_once = max(worst_once, _k5_margin(_k5_bf16_model(
                xdt, la, b, c, chunk=256, **once), want))
            worst_split = max(worst_split, _k5_margin(_k5_bf16_model(
                xdt, la, b, c, chunk=256), want))
    assert worst_once > 0 >= worst_split, (worst_once, worst_split)


# ------------------------------------------- K5's f32 kernel, its rounding
# A plain-torch model of the arithmetic of K5's f32 kernel
# (csrc/mamba_scan.cu, ``ssd_scan_f32_kernel``), products="fma": each
# output of the four products (the Gram C Bᵀ, the decayed scores S times
# xdt, C h0ᵀ and (xdt ⊙ w)ᵀ B) is one chain of f32 fused multiply-adds in
# ascending k from 0; the decays expf(min(cum_i - cum_j, 0)) of
# ``prefix_sum``'s f32 cum times the f32 Gram; w = exp(cum_last - cum_j)
# times xdt rounded to f32.  Per chunk: y = S xdt, plus fma(exp(cum),
# C h0ᵀ, ·) after the first chunk (where h0 is 0 and the kernel skips the
# product); h = fma(exp(cum_last), h0, (xdt w)ᵀ B).  Beside it the route
# the kernel did not take: the products on the tensor cores as three TF32
# products each (products="tf32x3": lo hi, hi lo, hi hi, with hi = tf32(x)
# and lo = tf32(x - hi), summed 8 terms an `mma.sync.m16n8k8` and rounded
# to f32 once per product), or as one (products="tf32", TF32 itself).
K5_F32_TOL = dict(rtol=5e-4, atol=5e-5)


def _tf32(x):
    """``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to 10
    mantissa bits, by integer ops on the f32 bits (as
    ``tests/test_torch_flash_attention.py`` models it)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _fma_chain(a, b, acc=None):
    """acc + (..., M, K) @ (..., K, N), each output one f32 fused
    multiply-add chain in ascending k (each product exact in f64, one
    rounding to f32 a step)."""
    out = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float64) \
        if acc is None else acc.double()
    ad, bd = a.double(), b.double()
    for k in range(a.shape[-1]):
        out = (out + ad[..., :, k, None] * bd[..., None, k, :]).float() \
            .double()
    return out.float()


def _mma_chain(a, b, acc=None, n_terms=3):
    """acc + (..., M, K) @ (..., K, N) in f32 as an `mma.sync.m16n8k8` chain
    takes it: per step of 8 k, each TF32 term product (lo hi, hi lo, hi hi;
    or hi hi alone for ``n_terms`` 1) summed exactly and added to the f32
    accumulator with one rounding."""
    ah, bh = _tf32(a), _tf32(b)
    pairs = [(_tf32(a - ah), bh), (ah, _tf32(b - bh)), (ah, bh)] \
        if n_terms == 3 else [(ah, bh)]
    out = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float64) \
        if acc is None else acc.double()
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            out = (out + x[..., k0:k0 + 8].double()
                   @ y[..., k0:k0 + 8, :].double()).float().double()
    return out.float()


def _fma(a, b, c):
    """fmaf(a, b, c) elementwise: the product exact in f64, one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _k5_f32_model(xdt, la, b, c, *, chunk, products="fma"):
    """(y f32, state f32) as K5's f32 kernel forms them (``products``
    "fma"), or on the tensor cores ("tf32x3", "tf32"), on the (BH, S, .)
    layout with B and C per head."""
    prod = {"fma": _fma_chain, "tf32x3": _mma_chain,
            "tf32": lambda a, b_, acc=None: _mma_chain(a, b_, acc, 1)}[
        products]
    bh, s, p = xdt.shape
    h = torch.zeros((bh, p, b.shape[-1]))
    y = torch.empty((bh, s, p))
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        x, bm, cm = xdt[:, sl].float(), b[:, sl].float(), c[:, sl].float()
        cum = prefix_sum(la[:, sl].float())
        n_c = cum.shape[1]
        causal = torch.ones((n_c, n_c), dtype=torch.bool).tril()
        gram = prod(cm, bm.transpose(1, 2))
        scores = torch.where(causal, gram * torch.exp(torch.clamp_max(
            cum[:, :, None] - cum[:, None, :], 0.0)), 0.0)
        yc = prod(scores, x)
        if c0 > 0:
            yc = _fma(torch.exp(cum)[..., None], prod(cm, h.transpose(1, 2)),
                      yc)
        xw = x * torch.exp(cum[:, -1:] - cum)[..., None]
        h = _fma(torch.exp(cum[:, -1])[:, None, None], h,
                 prod(xw.transpose(1, 2), bm))
        y[:, sl] = yc
    return y, h


def _jax_pallas(xdt, la, b, c, chunk):
    """The reference's Pallas ``ssd_scan`` in interpret mode on the same
    values, S padded to a multiple of the chunk with la = 0 and xdt = 0 (as
    the reference's ``ops.py`` pads): (y, state)."""
    s = xdt.shape[1]
    pad = (-s) % min(chunk, s)
    ts = [torch.nn.functional.pad(t.float(), (0, 0, 0, pad)) for t in
          (xdt, b, c)]
    lp = torch.nn.functional.pad(la.float(), (0, pad))
    jy, jh = jax_ssd_scan(jnp.asarray(ts[0].numpy()), jnp.asarray(lp.numpy()),
                          jnp.asarray(ts[1].numpy()),
                          jnp.asarray(ts[2].numpy()), chunk=chunk,
                          interpret=True)
    return (torch.from_numpy(np.array(jy))[:, :s],
            torch.from_numpy(np.array(jh)))


# K5_MODEL_CASES and phase 13's shape: S = 128 at chunk 256 (one chunk).
# With la down to -50 a step the prefix sums reach the thousands, where the
# reference's f32 cumsum rounds them in its own order (one ulp is about
# 2.4e-4 there) and the port's f64 prefix sum once: there the port's plain
# version misses the reference by as much as the model does, so those cases
# are held against the reference with la on a grid where every prefix sum
# is exact (``exact_cum``), and with la as drawn against the plain version,
# which shares the port's prefix sum.
K5_F32_MODEL_CASES = K5_MODEL_CASES + [(4, 128, 64, 128, 256, None),
                                       (4, 128, 64, 128, 256, -50.0)]


@pytest.mark.parametrize("bh,s,p,n,chunk,la_floor", K5_F32_MODEL_CASES)
def test_k5_f32_model_matches_reference_chunked_scan(bh, s, p, n, chunk,
                                                     la_floor):
    xdt, la, b, c = _k5_case(bh, s, p, n, 0, la_floor, torch.float32,
                             exact_cum=la_floor is not None)
    got = _k5_f32_model(xdt, la, b, c, chunk=chunk)
    assert got[0].dtype == torch.float32 and torch.isfinite(got[0]).all()
    assert _k5_margin(got, _jax_chunked(xdt, la, b, c, chunk),
                      K5_F32_TOL) <= 0
    # And the port's plain version, which the card holds K5 against, on la
    # as drawn.
    xdt, la, b, c = _k5_case(bh, s, p, n, 0, la_floor, torch.float32)
    assert _k5_margin(_k5_f32_model(xdt, la, b, c, chunk=chunk),
                      ssd_scan_plain(xdt, la, b, c, chunk=chunk),
                      K5_F32_TOL) <= 0


@pytest.mark.parametrize("bh,s,p,n,chunk,la_floor", K5_F32_MODEL_CASES)
def test_k5_f32_model_matches_reference_pallas_kernel(bh, s, p, n, chunk,
                                                      la_floor):
    """Against the reference's Pallas ``_ssd_kernel`` in interpret mode."""
    xdt, la, b, c = _k5_case(bh, s, p, n, 1, la_floor, torch.float32,
                             exact_cum=la_floor is not None)
    assert _k5_margin(_k5_f32_model(xdt, la, b, c, chunk=chunk),
                      _jax_pallas(xdt, la, b, c, chunk), K5_F32_TOL) <= 0


def test_k5_f32_products_on_the_tensor_cores_miss():
    """Why K5's f32 kernel keeps its products on f32 FMAs: as three TF32
    products each, a short last chunk with la down to -50 a step (S = 300,
    chunk 256, on the exact grid, seed 1) misses the reference's Pallas
    kernel by more than the f32 tolerance (small outputs of large terms:
    the split keeps about 21 bits of each operand), and as one TF32 product
    the serving path's shape misses it; the FMA chains hold both."""
    xdt, la, b, c = _k5_case(4, 300, 64, 128, 1, -50.0, torch.float32,
                             exact_cum=True)
    want = _jax_pallas(xdt, la, b, c, 256)
    margins = {products: _k5_margin(_k5_f32_model(
        xdt, la, b, c, chunk=256, products=products), want, K5_F32_TOL)
        for products in ("fma", "tf32x3")}
    xdt, la, b, c = _k5_case(4, 512, 64, 128, 0)
    xdt, b, c = xdt.float(), b.float(), c.float()
    want = _jax_pallas(xdt, la, b, c, 256)
    margins["tf32"] = _k5_margin(_k5_f32_model(
        xdt, la, b, c, chunk=256, products="tf32"), want, K5_F32_TOL)
    margins["fma_512"] = _k5_margin(_k5_f32_model(xdt, la, b, c, chunk=256),
                                    want, K5_F32_TOL)
    assert margins["tf32x3"] > 0 and margins["tf32"] > 0, margins
    assert margins["fma"] <= 0 and margins["fma_512"] <= 0, margins


def _recurrence_f64(xdt, la, b, c):
    """The sequential recurrence h_i = a_i h_{i-1} + xdt_i ⊗ B_i, y_i =
    h_i·C_i, all in f64: (y, final state)."""
    xdt, la, b, c = (t.double() for t in (xdt, la, b, c))
    h = torch.zeros((xdt.shape[0], xdt.shape[2], b.shape[2]),
                    dtype=torch.float64)
    ys = []
    for t in range(xdt.shape[1]):
        h = torch.exp(la[:, t])[:, None, None] * h \
            + xdt[:, t, :, None] * b[:, t, None, :]
        ys.append(torch.einsum("bpn,bn->bp", h, c[:, t]))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("seed", [0, 1])
def test_k5_f32_prefix_sum_diverges_from_reference_at_steep_decays(seed):
    """The port takes the prefix sum of la in f64 and rounds once
    (``ref.prefix_sum``); the reference's chunked scan takes it in f32.  On
    xdt (4, 512, 64), N 128, chunk 256, with the steepest la a step set to
    -1, -5 and -50 (the margin is max |port - reference| - (5e-5 + 5e-4
    |reference|) over y and the state): at -1 the port holds the
    reference's f32 tolerance; at -5 it misses it (by 9.9e-5 and 2.5e-4 on
    seeds 0 and 1); at -50 both miss the f64 sequential recurrence, and the
    port by less than the reference, so the reference's f32 cumsum sets the
    limit, not the port.  A design difference, kept (ROADMAP.md, section
    3)."""
    margins = {}
    for floor in (-1.0, -5.0, -50.0):
        xdt, la, b, c = _k5_case(4, 512, 64, 128, seed, floor, torch.float32)
        port = ssd_scan_plain(xdt, la, b, c, chunk=256)
        ref = _jax_chunked(xdt, la, b, c, 256)
        margins[floor] = _k5_margin(port, ref, K5_F32_TOL)
        if floor == -50.0:
            exact = _recurrence_f64(xdt, la, b, c)
            margins["port_f64"] = _k5_margin(port, exact, K5_F32_TOL)
            margins["ref_f64"] = _k5_margin(ref, exact, K5_F32_TOL)
    assert margins[-1.0] <= 0, margins
    assert margins[-5.0] > 0, margins
    assert margins[-50.0] > 0, margins
    assert 0 < margins["port_f64"] < margins["ref_f64"], margins
