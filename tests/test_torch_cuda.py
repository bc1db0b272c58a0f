"""The port's CUDA kernels on the card: each against its plain version, the
launch counters, and dispatch that raises instead of falling back.

Marked ``cuda``: without a CUDA device they skip (a CUDA kernel has no
interpret mode).  On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.cluster import Cluster, MatmulJob, TrainJob
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mamba_scan import mamba_scan as k5
from repro_torch.kernels.mamba_scan.ops import ssd
from repro_torch.kernels.mamba_scan.ref import (
    ssd_scan_bwd_plain,
    ssd_scan_plain,
    ssd_scan_ref,
)
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.prefill import prefill as pf
from repro_torch.kernels.prefill.ops import prefill_attention
from repro_torch.kernels.prefill.ref import prefill_ref
from repro_torch.models import Model
from repro_torch.train import make_grain_grad_fn
from repro_torch.tree import tree_leaves

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (5e-4, 5e-5), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


#: Host seconds between the start of a profiler session and the first
#: launch it must record: the profiler drops device events stamped before
#: its session began, and CUPTI's stamps of the card's kernels read early,
#: by tens of milliseconds after a minute of load (scripts/profiler_probe.py;
#: at 20 ms, as ``chip_smoke.PROFILE_LEAD_S`` for young processes, a whole
#: run of this file lost the first kernels of a call, and at 500 ms still
#: some).  So a session runs the call PROFILE_CALLS times, PROFILE_GAP_S
#: apart, and reads the kernels any of them recorded.
PROFILE_LEAD_S = 0.2
PROFILE_CALLS, PROFILE_GAP_S = 8, 0.1


def _device_kernels(run) -> set[str]:
    """Names of the device kernels that ``run()`` launches, from
    ``torch.profiler``'s CUDA events; ``run()`` runs once before the
    session (a kernel's first launch in a process loads it, which delays
    the launches after it), then PROFILE_CALLS times in it from
    PROFILE_LEAD_S after its start."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_LEAD_S)
        for _ in range(PROFILE_CALLS):
            run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_GAP_S)
    return {e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


# The last four: the MoE and dense serves' groups at D 128, group 1 (16
# heads, Qwen1.5-MoE), 4 (32 over 8, Qwen3-8B and Jamba) and 48 (one KV
# head, Granite-34B; also at a tile edge).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,s", [(2, 2, 16, 32), (4, 2, 16, 48),
                                        (16, 2, 128, 100), (8, 1, 64, 300),
                                        (16, 16, 128, 512), (32, 8, 128, 512),
                                        (48, 1, 128, 512), (48, 1, 128, 129)])
def test_prefill_flash_matches_plain(dev, hq, hkv, d, s, dtype):
    q = _rand((hq, s, d), dtype, dev, 1)
    k, v = _rand((hkv, s, d), dtype, dev, 2), _rand((hkv, s, d), dtype, dev, 3)
    before = pf.LAUNCHES["prefill_flash"]
    out, kc, vc = pf.prefill_flash(q, k, v, group=hq // hkv)
    assert pf.LAUNCHES["prefill_flash"] == before + 1
    ref, _, _ = prefill_ref(q, k, v, group=hq // hkv)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    assert kc is k and vc is v


# Tile edges of K1's 64-row tiles in bf16 (the tensor-core kernel): S of 1,
# 17, 63, 65, 127 and 129, groups 1, 2, 4 and 8, every compiled D.
K1_EDGE_SHAPES = [(1, 1, 1, 16), (17, 2, 1, 128), (63, 4, 2, 32),
                  (65, 8, 1, 16), (127, 8, 1, 128), (129, 2, 2, 64),
                  (65, 4, 1, 64), (129, 16, 2, 128)]


@pytest.mark.parametrize("s,hq,hkv,d", K1_EDGE_SHAPES)
def test_prefill_flash_bf16_tile_edges_match_plain(dev, s, hq, hkv, d):
    q = _rand((hq, s, d), torch.bfloat16, dev, 1)
    k = _rand((hkv, s, d), torch.bfloat16, dev, 2)
    v = _rand((hkv, s, d), torch.bfloat16, dev, 3)
    before = pf.LAUNCHES["prefill_flash"]
    out, _, _ = pf.prefill_flash(q, k, v, group=hq // hkv)
    assert pf.LAUNCHES["prefill_flash"] == before + 1
    ref, _, _ = prefill_ref(q, k, v, group=hq // hkv)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_prefill_flash_bf16_needs_16_byte_aligned_inputs(dev):
    """The bf16 kernel copies rows 16 bytes at a time: an input that starts
    off a 16-byte boundary raises instead of launching."""
    flat = torch.zeros(4 * 16 * 16 + 1, dtype=torch.bfloat16, device=dev)
    q = flat[1:].view(4, 16, 16)
    assert q.is_contiguous()
    k = torch.zeros((2, 16, 16), dtype=torch.bfloat16, device=dev)
    before = dict(pf.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        pf.prefill_flash(q, k, k, group=2)
    assert pf.LAUNCHES == before


# Tile edges of the f32 forward body's 64-row tiles and 4-key steps, which
# K1's f32 and f16 kernel shares with K4's f32 forward: S of 1, 17, 63, 65,
# 127, 129 and 1024, groups 1, 2, 4 and 8, every compiled D.  (s, hq, hkv, d)
K1_F32_EDGE_SHAPES = [(1, 1, 1, 16), (17, 2, 1, 128), (63, 4, 2, 32),
                      (65, 8, 1, 16), (127, 8, 1, 128), (129, 2, 2, 64),
                      (1024, 8, 1, 64), (1024, 4, 1, 32), (127, 16, 2, 128)]


@pytest.mark.parametrize("s,hq,hkv,d", K1_F32_EDGE_SHAPES)
def test_prefill_flash_f32_and_f16_tile_edges(dev, s, hq, hkv, d):
    """K1 in f32 against its plain version; in f16 (staged to f32 exactly,
    the same f32 body, one rounding) bit for bit the f32 kernel's output on
    the same values, rounded to f16; and in f32 bit for bit K4's f32
    forward on the same causal inputs, since the two share one body."""
    group = hq // hkv
    q = _rand((hq, s, d), torch.float16, dev, 1)
    k = _rand((hkv, s, d), torch.float16, dev, 2)
    v = _rand((hkv, s, d), torch.float16, dev, 3)
    q32, k32, v32 = q.float(), k.float(), v.float()
    before = pf.LAUNCHES["prefill_flash"]
    out32, _, _ = pf.prefill_flash(q32, k32, v32, group=group)
    out16, _, _ = pf.prefill_flash(q, k, v, group=group)
    assert pf.LAUNCHES["prefill_flash"] == before + 2
    ref, _, _ = prefill_ref(q32, k32, v32, group=group)
    torch.testing.assert_close(out32, ref, rtol=5e-4, atol=5e-5)
    assert out16.dtype == torch.float16
    assert torch.equal(out16, out32.to(torch.float16))
    k4_out, _, _ = fa.flash_attention_fwd(q32, k32, v32, causal=True,
                                          group=group)
    assert torch.equal(out32, k4_out)


def test_prefill_flash_f32_path_shape_is_k4_bitwise(dev):
    """Phase 4's shape, q (16, 128, 128), k/v (2, 128, 128), group 8,
    causal, f32: K1's output is K4's f32 out bit for bit, and within the f32
    tolerance of the plain version."""
    q = _rand((16, 128, 128), torch.float32, dev, 4)
    k = _rand((2, 128, 128), torch.float32, dev, 5)
    v = _rand((2, 128, 128), torch.float32, dev, 6)
    out, _, _ = pf.prefill_flash(q, k, v, group=8)
    k4_out, _, _ = fa.flash_attention_fwd(q, k, v, group=8)
    assert torch.equal(out, k4_out)
    ref, _, _ = prefill_ref(q, k, v, group=8)
    torch.testing.assert_close(out, ref, rtol=5e-4, atol=5e-5)


def test_f32_forward_off_a_16_byte_boundary_keeps_its_bits(dev):
    """f32 inputs that start off a 16-byte boundary are staged by plain
    loads instead of cp.async: K1's and K4's outputs (and K4's lse) are the
    bits of the same values on aligned storage."""
    q = _rand((4, 129, 64), torch.float32, dev, 7)
    k = _rand((2, 129, 64), torch.float32, dev, 8)
    v = _rand((2, 129, 64), torch.float32, dev, 9)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=dev)
        off = flat[1:].view(t.shape)
        off.copy_(t)
        assert off.is_contiguous() and off.data_ptr() % 16
        return off

    qs, ks, vs = shifted(q), shifted(k), shifted(v)
    for causal in (True, False):
        want = fa.flash_attention_fwd(q, k, v, causal=causal, group=2)
        got = fa.flash_attention_fwd(qs, ks, vs, causal=causal, group=2)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(pf.prefill_flash(qs, ks, vs, group=2)[0],
                       pf.prefill_flash(q, k, v, group=2)[0])


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "prefill_flash_mma_kernel"),
    (torch.float32, "prefill_flash_f32_kernel")])
def test_prefill_flash_launches_the_kernel_of_its_dtype(dev, dtype, kernel):
    """bf16 on the tensor cores, f32 on the CUDA cores."""
    q = _rand((16, 128, 128), dtype, dev, 1)
    k, v = _rand((2, 128, 128), dtype, dev, 2), _rand((2, 128, 128), dtype,
                                                      dev, 3)
    names = _device_kernels(lambda: pf.prefill_flash(q, k, v, group=8))
    assert [n for n in names if "prefill_flash" in n and kernel + "<" in n], \
        names


def test_cache_cast_is_bitwise_and_counted(dev):
    k, v = _rand((2, 48, 16), torch.float32, dev, 4), _rand((2, 48, 16),
                                                             torch.float32, dev, 5)
    before = dict(pf.LAUNCHES)
    out, kc, vc = pf.prefill_flash(_rand((4, 48, 16), torch.float32, dev, 6),
                                   k, v, group=2, cache_dtype=torch.bfloat16)
    assert pf.LAUNCHES["prefill_flash"] == before["prefill_flash"] + 1
    assert pf.LAUNCHES["cache_cast"] == before["cache_cast"] + 1
    assert torch.equal(kc, k.to(torch.bfloat16))
    assert torch.equal(vc, v.to(torch.bfloat16))


def _shifted(t):
    """A contiguous copy of ``t`` that starts one element past an aligned
    allocation, so off every 4-, 8- and 16-byte boundary its element size
    allows."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    off = flat[1:].view(t.shape)
    off.copy_(t)
    assert off.is_contiguous() and off.data_ptr() % 16
    return off


_CAST_TYPES = (torch.float32, torch.bfloat16, torch.float16)


@pytest.mark.parametrize("layout", ["path", "ragged", "unaligned"])
@pytest.mark.parametrize("src", _CAST_TYPES, ids=str)
@pytest.mark.parametrize("dst", _CAST_TYPES, ids=str)
def test_cache_cast_is_bitwise_to(dev, layout, src, dst):
    """K2 is ``.to`` bit for bit for every pair of types it takes: at the
    model path's shape (four-element pieces), at an element count that is
    not a multiple of 4 (a scalar tail), and on views off a 16-byte
    boundary (the scalar route)."""
    shape = (2, 37, 5) if layout == "ragged" else (2, 128, 128)
    k, v = (_rand(shape, torch.float32, dev, seed).mul_(300).to(src)
            for seed in (11, 12))
    if layout == "unaligned":
        k, v = _shifted(k), _shifted(v)
    before = pf.LAUNCHES["cache_cast"]
    kc, vc = pf.cache_cast(k, v, dst)
    assert pf.LAUNCHES["cache_cast"] == before + 1
    assert kc.dtype == dst and torch.equal(kc, k.to(dst))
    assert vc.dtype == dst and torch.equal(vc, v.to(dst))


def test_cuda_tensor_raises_instead_of_falling_back(dev):
    q = torch.zeros((2, 16, 16), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="not supported"):
        pf.prefill_flash(q, q, q)
    q = torch.zeros((2, 16, 24), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        pf.prefill_flash(q, q, q)


def test_prefill_op_layout_and_model_launches(dev):
    q = _rand((1, 40, 4, 16), torch.float32, dev, 7)
    k, v = _rand((1, 40, 2, 16), torch.float32, dev, 8), _rand(
        (1, 40, 2, 16), torch.float32, dev, 9)
    out, kc, vc = prefill_attention(q, k, v)
    ref, _, _ = prefill_attention(q, k, v, use_pallas=False)
    torch.testing.assert_close(out, ref, rtol=5e-4, atol=5e-5)
    cfg = get_config("qwen2-1.5b", reduced=True)
    m = Model(dataclasses.replace(cfg, use_pallas=None))
    before = pf.LAUNCHES["prefill_flash"]
    m.prefill(m.init(0), {"tokens": torch.zeros((1, 16), dtype=torch.long,
                                                device=dev)})
    assert pf.LAUNCHES["prefill_flash"] == before + cfg.n_layers


# The 64 x 64 tile's shapes, then K3's 8-column strip tile (M <= 16, the
# TDA's grains) at K of 1, 31, 32, 33 (ragged and exact K tiles), 1000 and
# 4096 (the path's depths) and ragged N of 37 (no row on a 16-byte
# boundary: plain loads) and 1000 (16-byte rows: cp.async).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (2, 96, 70), (100, 70, 36),
                                   (513, 129, 257), (2, 1000, 1000)] + [
    (m, k, n) for m in (1, 2, 3, 16) for k in (1, 31, 32, 33, 1000, 4096)
    for n in (37, 1000)])
def test_matmul_kernel_matches_plain(dev, m, k, n, dtype):
    x = _rand((m, k), dtype, dev, 10) * k ** -0.25
    y = _rand((k, n), dtype, dev, 11) * k ** -0.25
    before = mm.LAUNCHES["matmul"]
    out = matmul(x.to(dtype), y.to(dtype))
    assert mm.LAUNCHES["matmul"] == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), matmul_ref(x.to(dtype),
                                                       y.to(dtype)).float(),
                               rtol=rtol, atol=atol)


def test_matmul_kernel_row_slices_are_bitwise(dev):
    x, y = _rand((130, 300), torch.float32, dev, 12), _rand(
        (300, 200), torch.float32, dev, 13)
    full = matmul(x, y)
    for lo in range(0, 129):
        assert torch.equal(matmul(x[lo:lo + 2], y), full[lo:lo + 2]), lo


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(1000, 1000), (96, 37), (33, 200)])
def test_matmul_strip_rows_equal_the_64_tile_rows_bitwise(dev, k, n, dtype):
    """Slices of 1 to 16 rows (the strip tile) equal the rows of the full
    130-row product (the 64 x 64 tile) bit for bit."""
    x = _rand((130, k), torch.float32, dev, 18).to(dtype)
    y = _rand((k, n), torch.float32, dev, 19).to(dtype)
    full = matmul(x, y)
    for rows in (1, 2, 3, 16):
        for lo in (0, 1, 63, 64, 130 - rows):
            assert torch.equal(matmul(x[lo:lo + rows], y),
                               full[lo:lo + rows]), (rows, lo)


@pytest.mark.parametrize("m,kernel", [(2, "matmul_strip_kernel"),
                                      (16, "matmul_strip_kernel"),
                                      (17, "matmul_kernel<")])
def test_matmul_launches_the_tile_of_its_m(dev, m, kernel):
    x = _rand((m, 256), torch.float32, dev, 20)
    y = _rand((256, 256), torch.float32, dev, 21)
    names = _device_kernels(lambda: matmul(x, y))
    assert [n for n in names if kernel in n], names


def test_matmul_kernel_raises_instead_of_falling_back(dev):
    x = torch.zeros((4, 4), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="f32 or bf16"):
        mm.matmul(x, x)
    x = torch.zeros((4, 4), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        mm.matmul(x.t(), x)


def test_matmul_job_on_the_card_is_k3_bitwise(dev):
    a = _rand((64, 48), torch.float32, dev, 14)
    b = _rand((48, 40), torch.float32, dev, 15)
    before = mm.LAUNCHES["matmul"]
    rep = Cluster("2:1", device="cuda").simulate(MatmulJob(a, b,
                                                           matmul_fn=matmul))
    assert mm.LAUNCHES["matmul"] == before + 32
    assert rep.artifact.device.type == "cuda"
    assert torch.equal(rep.artifact, matmul(a, b))
    assert rep.metrics["max_abs_err"] < 1e-4


# ------------------------------------------------------------ K4 (training)
# (b, sq, skv, hq, hkv, d, magnitude): the reference's kernel-test shapes
# (tests/test_kernels.py, the x30 logits too), Sq != Skv both ways, ragged
# S, the path's GQA.
K4_SHAPES = [(2, 128, 128, 4, 2, 64, 1.0), (1, 256, 256, 2, 2, 32, 1.0),
             (2, 64, 64, 4, 1, 16, 1.0), (1, 64, 64, 1, 1, 16, 30.0),
             (1, 100, 100, 4, 2, 16, 1.0), (1, 40, 72, 2, 1, 32, 1.0),
             (1, 130, 48, 4, 2, 64, 1.0), (1, 300, 300, 16, 2, 128, 1.0)]


def _k4_inputs(dev, b, sq, skv, hq, hkv, d, dtype, mag=1.0):
    q = _rand((b * hq, sq, d), torch.float32, dev, 20) * mag
    k = _rand((b * hkv, skv, d), torch.float32, dev, 21) * mag
    v = _rand((b * hkv, skv, d), torch.float32, dev, 22)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,mag", K4_SHAPES)
def test_flash_attention_fwd_bwd_match_plain(dev, b, sq, skv, hq, hkv, d, mag,
                                             causal, dtype):
    group = hq // hkv
    q, k, v = _k4_inputs(dev, b, sq, skv, hq, hkv, d, dtype, mag)
    dout = _rand(q.shape, torch.float32, dev, 23).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(*leaves, causal=causal, group=group)
    grads = torch.autograd.grad(out, leaves, dout)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkdv": 1}
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, causal=causal, group=group)
    ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    grtol, gatol = (1e-3, 1e-4) if dtype == torch.float32 else (rtol, atol)
    for name, g, r in zip("qkv", grads, ref_grads, strict=True):
        assert g.dtype == dtype, name
        torch.testing.assert_close(g.float(), r.float(), rtol=grtol,
                                   atol=gatol, msg=f"d{name}")


def test_flash_attention_large_logits_and_bitwise_backward(dev):
    """The reference's x30-magnitude case: no overflow in the online
    softmax; and the backward gives the same bits on every run."""
    q, k, v = _k4_inputs(dev, 1, 64, 64, 1, 1, 16, torch.float32, mag=30.0)
    out, lse, out32 = fa.flash_attention_fwd(q, k, v)
    assert out32 is out
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out, flash_attention_ref(q, k, v),
                               rtol=5e-4, atol=5e-5)
    q, k, v = _k4_inputs(dev, 1, 300, 300, 16, 2, 128, torch.bfloat16)
    out, lse, out32 = fa.flash_attention_fwd(q, k, v, group=8)
    assert out32.dtype == torch.float32
    torch.testing.assert_close(out32.to(torch.bfloat16), out, rtol=0, atol=0)
    dout = _rand(q.shape, torch.float32, dev, 24).to(torch.bfloat16)
    first = fa.flash_attention_bwd(q, k, v, out32, lse, dout, group=8)
    for _ in range(3):
        again = fa.flash_attention_bwd(q, k, v, out32, lse, dout, group=8)
        for a, b in zip(first, again, strict=True):
            assert torch.equal(a, b)


# Tile edges of the bf16 kernels' 64-row tiles and 32-query steps: Sq and
# Skv of 1, 17, 63, 65, 127 and 129, Sq above and below Skv, groups 1, 2, 4
# and 8, every compiled D; and group 48 (Granite-34B's one KV head for 48 q
# heads: dK/dV's f32 partials of 48 heads a KV row, summed by the
# reduction).
K4_EDGE_SHAPES = [(1, 1, 1, 1, 1, 16), (1, 1, 129, 2, 1, 32),
                  (1, 129, 1, 8, 1, 64), (1, 17, 17, 2, 1, 128),
                  (2, 63, 65, 4, 2, 32), (1, 65, 63, 8, 1, 16),
                  (1, 127, 129, 8, 1, 128), (1, 129, 127, 2, 2, 64),
                  (1, 65, 127, 2, 1, 16), (1, 129, 17, 4, 2, 128),
                  (1, 128, 128, 48, 1, 128), (1, 65, 129, 48, 1, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", K4_EDGE_SHAPES)
def test_flash_attention_tile_edges_match_plain(dev, b, sq, skv, hq, hkv, d,
                                                causal, dtype):
    """The forward against the plain version; the gradients against
    autograd through the plain version in f32 on the same values (on bf16
    leaves it rounds each q head's dK, dV before the group sum, which alone
    misses the exact gradient at Skv = 1, group 8: see
    test_torch_flash_attention.py)."""
    group = hq // hkv
    q, k, v = _k4_inputs(dev, b, sq, skv, hq, hkv, d, dtype)
    dout = _rand(q.shape, torch.float32, dev, 23).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, group=group)
    grads = torch.autograd.grad(out, leaves, dout)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q, k, v, causal=causal,
                                         group=group).float(),
        rtol=rtol, atol=atol)
    ref_leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref_grads = torch.autograd.grad(
        flash_attention_ref(*ref_leaves, causal=causal, group=group),
        ref_leaves, dout.float())
    grtol, gatol = (1e-3, 1e-4) if dtype == torch.float32 else (rtol, atol)
    for name, g, r in zip("qkv", grads, ref_grads, strict=True):
        assert g.dtype == dtype, name
        torch.testing.assert_close(g.float(), r, rtol=grtol, atol=gatol,
                                   msg=f"d{name}")


# The f32 forward alone at its tile edges, Sq and Skv of 1 to 1024 (the
# backward's edges are above): out against the plain version and lse
# against the log-sum-exp of the plain version's scores.
# (b, sq, skv, hq, hkv, d)
K4_F32_FWD_EDGE_SHAPES = [(1, 1024, 1024, 8, 1, 64), (1, 1024, 129, 4, 2, 16),
                          (1, 65, 1024, 2, 1, 128), (2, 1024, 63, 2, 2, 32),
                          (1, 17, 1024, 4, 1, 128), (1, 127, 65, 8, 1, 32)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", K4_F32_FWD_EDGE_SHAPES)
def test_flash_attention_f32_forward_tile_edges(dev, b, sq, skv, hq, hkv, d,
                                                causal):
    from repro_torch.kernels.flash_attention.ref import scores_ref

    group = hq // hkv
    q, k, v = _k4_inputs(dev, b, sq, skv, hq, hkv, d, torch.float32)
    before = fa.LAUNCHES["flash_attention_fwd"]
    out, lse, out32 = fa.flash_attention_fwd(q, k, v, causal=causal,
                                             group=group)
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    assert out32 is out
    torch.testing.assert_close(
        out, flash_attention_ref(q, k, v, causal=causal, group=group),
        rtol=5e-4, atol=5e-5)
    s = scores_ref(q, torch.repeat_interleave(k, group, 0))
    if causal:
        qi = torch.arange(sq, device=dev)[:, None]
        s = torch.where(qi >= torch.arange(skv, device=dev)[None, :], s,
                        float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=5e-4,
                               atol=5e-5)


def test_flash_attention_path_shape_bf16_matches_plain_and_is_bitwise(dev):
    """The training path's q (16, 1024, 128), k/v (2, 1024, 128), bf16,
    causal: forward and backward against the plain version and autograd
    through it, one launch of each kernel; the backward the same bits over
    repeated runs."""
    q, k, v = _k4_inputs(dev, 1, 1024, 1024, 16, 2, 128, torch.bfloat16)
    dout = _rand(q.shape, torch.float32, dev, 26).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(*leaves, group=8)
    grads = torch.autograd.grad(out, leaves, dout)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkdv": 1}
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, group=8)
    ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    for name, g, r in zip("qkv", grads, ref_grads, strict=True):
        torch.testing.assert_close(g.float(), r.float(), rtol=2e-2,
                                   atol=2e-2, msg=f"d{name}")
    _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=8)
    torch.testing.assert_close(out32.to(torch.bfloat16), out.detach(),
                               rtol=0, atol=0)
    first = fa.flash_attention_bwd(q, k, v, out32, lse, dout, group=8)
    for _ in range(3):
        again = fa.flash_attention_bwd(q, k, v, out32, lse, dout, group=8)
        for a, b in zip(first, again, strict=True):
            assert torch.equal(a, b)


def test_flash_attention_path_shape_f32_matches_plain_and_is_bitwise(dev):
    """The training path's q (16, 1024, 128), k/v (2, 1024, 128), f32,
    causal (the f32 grain check's shape): forward and backward against the
    plain version and autograd through it at the f32 tolerances, one launch
    of each kernel; the backward the same bits over repeated runs."""
    q, k, v = _k4_inputs(dev, 1, 1024, 1024, 16, 2, 128, torch.float32)
    dout = _rand(q.shape, torch.float32, dev, 29)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(*leaves, group=8)
    grads = torch.autograd.grad(out, leaves, dout)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkdv": 1}
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, group=8)
    ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
    torch.testing.assert_close(out, ref, rtol=5e-4, atol=5e-5)
    for name, g, r in zip("qkv", grads, ref_grads, strict=True):
        assert g.dtype == torch.float32, name
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4,
                                   msg=f"d{name}")
    _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=8)
    first = fa.flash_attention_bwd(q, k, v, out32, lse, dout, group=8)
    for _ in range(3):
        again = fa.flash_attention_bwd(q, k, v, out32, lse, dout, group=8)
        for a, b in zip(first, again, strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seed", range(20))
def test_flash_attention_f32_x30_logits_match_autograd(dev, seed, causal):
    """The reference's x30-logit case (1 x 64 x 64, D = 16, q and k times
    30) at numpy seeds 0-19, drawn as tests/test_torch_flash_attention.py
    draws them for the CPU model of the f32 backward.  Scores in the
    thousands leave GRAD_TOL almost no room, and the model sums each
    8-term TF32 product exactly before one rounding, which the tensor
    cores need not do; so the kernels' own gradients are held against
    autograd through the plain version on the same values, on the card
    and on the CPU."""
    r = np.random.default_rng(seed)
    q, k, v, dout = (
        torch.from_numpy((r.standard_normal((1, 64, 1, 16)) * mag)
                         .astype(np.float32).reshape(1, 64, 16))
        for mag in (30.0, 30.0, 1.0, 1.0))
    leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention(*leaves, causal=causal),
                                leaves, dout.to(dev))
    for where in (dev, torch.device("cpu")):
        ref_leaves = [t.to(where).requires_grad_(True) for t in (q, k, v)]
        ref_grads = torch.autograd.grad(
            flash_attention_ref(*ref_leaves, causal=causal), ref_leaves,
            dout.to(where))
        for name, g, want in zip("qkv", grads, ref_grads, strict=True):
            torch.testing.assert_close(g.cpu(), want.cpu(), rtol=1e-3,
                                       atol=1e-4, msg=f"d{name} on {where}")


# SHA-256 of the f32 forward's out and lse on inputs from a CUDA generator
# seeded 0, drawn in order (q, k, v for each case): the training path's
# shape, the x30 logits and a ragged GQA shape.  The kernel computed these
# bits before its score loop became the chain that the f32 backward
# recomputes the scores by, and computes them after.  They are the bits of
# one build (nvcc for sm_90a): a new toolkit, or a deliberate change of
# the forward's arithmetic, moves them, and then they are taken anew.
K4_F32_FWD_DIGESTS = [
    (((16, 1024, 128), (2, 1024, 128), 8, True, 1.0),
     "d25cb412f0a337ef00d45f0c81e5c14420f72621608a4796ae9cee38f8b2468d",
     "c7b4d73eff72297b3410a4c72313ae92a2d149a5cd40470adf27f927425f7253"),
    (((1, 64, 16), (1, 64, 16), 1, True, 30.0),
     "33ae574626a6d56c27afd70abb2313a6d5946dc5c6e1c9a1ce67087d0a5546d8",
     "6b7a14c61727b15d253c2af1949b819c7e3b21751e271541915ac3693a16f4ec"),
    (((4, 129, 64), (2, 127, 64), 2, False, 1.0),
     "c54f32b451bd93349a2618f9c1616ef6acbe982688e89b01f1718141de3231c0",
     "2287c98f70d97508a8ae56e284e00d19e6817d2497b8682df2bdd95eb827b848"),
]


def test_flash_attention_f32_forward_keeps_its_bits(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for (qs, ks, group, causal, mag), *want in K4_F32_FWD_DIGESTS:
        q = torch.randn(qs, generator=gen, device=dev) * mag
        k = torch.randn(ks, generator=gen, device=dev) * mag
        v = torch.randn(ks, generator=gen, device=dev)
        out, lse, _ = fa.flash_attention_fwd(q, k, v, causal=causal,
                                             group=group)
        got = [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
               for t in (out, lse)]
        assert got == want, (qs, ks)


def test_flash_attention_f32_backward_needs_16_byte_aligned_inputs(dev):
    """The f32 backward kernels copy rows 16 bytes at a time: an input that
    starts off a 16-byte boundary raises instead of launching; the
    autograd function copies such a view first."""
    k = torch.randn((2, 16, 16), device=dev)
    _, lse, out32 = fa.flash_attention_fwd(k, k, k)
    flat = torch.randn(k.numel() + 1, device=dev)
    off = flat[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd_dq(off, k, k, out32, lse, k)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd_dkdv(k, k, k, lse, off, lse)
    leaves = [t.clone().requires_grad_(True) for t in (off, k, k)]
    grads = torch.autograd.grad(fa.flash_attention(*leaves), leaves,
                                torch.ones_like(k))
    ref_leaves = [t.clone().requires_grad_(True) for t in (off, k, k)]
    ref_grads = torch.autograd.grad(flash_attention_ref(*ref_leaves),
                                    ref_leaves, torch.ones_like(k))
    for g, r in zip(grads, ref_grads, strict=True):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4)


def test_flash_dq_path_shape_bitwise_and_row_term(dev):
    """The bf16 dQ kernel at the training path's shape: the same bits over
    repeated runs, and its row term rowsum(dO * O) (the dK/dV kernel's
    input) within f32 tolerance of torch's on the forward's f32 output."""
    q, k, v = _k4_inputs(dev, 1, 1024, 1024, 16, 2, 128, torch.bfloat16)
    dout = _rand(q.shape, torch.float32, dev, 27).to(torch.bfloat16)
    _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=8)
    dq, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout, group=8)
    assert dq.dtype == torch.bfloat16 and drow.dtype == torch.float32
    torch.testing.assert_close(drow, (dout.float() * out32).sum(-1),
                               rtol=5e-4, atol=5e-5)
    for _ in range(3):
        again = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout, group=8)
        assert torch.equal(dq, again[0]) and torch.equal(drow, again[1])


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "flash_fwd_mma_kernel"),
    (torch.float32, "flash_fwd_f32_kernel")])
def test_flash_fwd_launches_the_kernel_of_its_dtype(dev, dtype, kernel):
    """bf16 on the tensor cores, f32 on the CUDA cores (the body K1's f32
    kernel shares)."""
    q, k, v = _k4_inputs(dev, 1, 128, 128, 16, 2, 128, dtype)
    names = _device_kernels(lambda: fa.flash_attention_fwd(q, k, v, group=8))
    assert [n for n in names if kernel + "<" in n], names


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "flash_dq_mma_kernel"),
    (torch.float32, "flash_dq_tf32_kernel")])
def test_flash_dq_launches_the_kernel_of_its_dtype(dev, dtype, kernel):
    """bf16 on the tensor cores in bf16, f32 as three TF32 products."""
    q, k, v = _k4_inputs(dev, 1, 128, 128, 16, 2, 128, dtype)
    dout = _rand(q.shape, torch.float32, dev, 28).to(dtype)
    _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=8)
    names = _device_kernels(lambda: fa.flash_attention_bwd_dq(
        q, k, v, out32, lse, dout, group=8))
    assert [n for n in names if kernel + "<" in n], names


@pytest.mark.parametrize("dtype,kernel,out_type", [
    (torch.bfloat16, "flash_dkdv_mma_kernel", "__nv_bfloat16"),
    (torch.float32, "flash_dkdv_tf32_kernel", "float")])
def test_flash_dkdv_launches_the_kernel_of_its_dtype(dev, dtype, kernel,
                                                     out_type):
    """The dK/dV kernel of the dtype, then for group 8 the head-order
    reduction of its per-head partials into the dtype; none for group 1."""
    for hkv, group in ((2, 8), (16, 1)):
        q, k, v = _k4_inputs(dev, 1, 128, 128, 16, hkv, 128, dtype)
        dout = _rand(q.shape, torch.float32, dev, 28).to(dtype)
        _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=group)
        _, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                            group=group)
        names = _device_kernels(lambda: fa.flash_attention_bwd_dkdv(
            q, k, v, lse, dout, drow, group=group))
        assert [n for n in names if kernel + "<" in n], names
        reduce = [n for n in names if "flash_dkdv_reduce_kernel<" in n]
        if group == 1:
            assert not reduce, names
        else:
            assert reduce and all(out_type in n for n in reduce), names


def test_flash_attention_bf16_needs_16_byte_aligned_inputs(dev):
    """The bf16 kernels copy rows 16 bytes at a time: an input that starts
    off a 16-byte boundary raises instead of launching."""
    flat = torch.zeros(2 * 16 * 16 + 1, dtype=torch.bfloat16, device=dev)
    q = flat[1:].view(2, 16, 16)
    assert q.is_contiguous()
    k = torch.zeros((2, 16, 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, k, k)
    _, lse, out32 = fa.flash_attention_fwd(k, k, k)
    flat = torch.zeros(out32.numel() + 1, device=dev)
    off32 = flat[1:].view(out32.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd_dq(k, k, k, off32, lse, k)


def test_flash_attention_raises_instead_of_falling_back(dev):
    q = torch.zeros((2, 16, 16), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="f32 or bf16"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((2, 16, 24), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((2, 16, 16), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), q, q)


def test_train_grain_on_kernels_matches_plain_and_counts(dev):
    """Reduced Qwen2 with padded q heads: one grain's loss and gradients on
    the K4 path against use_pallas=False; K4 launches 2 forwards (forward
    and recompute) and one of each backward kernel per layer."""
    cfg = get_config("qwen2-1.5b", reduced=True, tp_pad_heads=8)
    model = Model(dataclasses.replace(cfg, use_pallas=None))
    plain = Model(dataclasses.replace(cfg, use_pallas=False))
    params = model.init(0)
    g = torch.Generator().manual_seed(25)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g).to(dev)
    batch = {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int(),
             "loss_mask": torch.ones((2, 64), device=dev)}
    before = dict(fa.LAUNCHES)
    (loss, _), grads = make_grain_grad_fn(model)(params, batch)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention_fwd": 2 * cfg.n_layers,
        "flash_attention_bwd_dq": cfg.n_layers,
        "flash_attention_bwd_dkdv": cfg.n_layers}
    (loss_p, _), grads_p = make_grain_grad_fn(plain)(params, batch)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_p), strict=True):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5)


def test_train_adaptive_and_static_are_bitwise_on_the_card(dev):
    cfg = get_config("qwen2-1.5b", reduced=True, tp_pad_heads=8,
                     param_dtype="bfloat16", compute_dtype="bfloat16")
    model = Model(dataclasses.replace(cfg, use_pallas=None))

    def run(adaptive):
        rep = Cluster("4:3:2:1", adaptive=adaptive).train(
            TrainJob(model, steps=2, grains=8, seq_len=64),
            scenario="halve:w0@1:25%")
        return rep, tree_leaves(rep.artifact.state.params)

    (ra, pa), (rs, ps) = run(True), run(False)
    assert [p.metrics["loss"] for p in ra.phases] == \
        [p.metrics["loss"] for p in rs.phases]
    assert all(torch.equal(a, b) for a, b in zip(pa, ps, strict=True))


# --------------------------------------------------------- K5 (SSD scan)
def _ssd_inputs(dev, b, s, h, p, g, n, dtype, seed=30):
    """The reference test's input recipe (tests/test_kernels.py), drawn on
    the card: x, dt (softplus-sized, > 0), a < 0, B, C, D."""
    x = _rand((b, s, h, p), dtype, dev, seed)
    dt = (_rand((b, s, h), torch.float32, dev, seed + 1).abs() * 0.1
          + 0.01).to(dtype)
    a = -_rand((h,), torch.float32, dev, seed + 2).abs() - 0.1
    bm, cm = (_rand((b, s, g, n), dtype, dev, seed + i) for i in (3, 4))
    return x, dt, a, bm, cm, _rand((h,), torch.float32, dev, seed + 5)


def _ssd_plain(x, dt, a, bm, cm, d, chunk):
    """``ssd``'s kernel route with K5's plain version in place of K5."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    rep = h // g
    xdt = (x * dt[..., None]).transpose(1, 2).reshape(b * h, s, p)
    la = (dt * a[None, None, :]).transpose(1, 2).reshape(b * h, s)
    bf, cf = (torch.repeat_interleave(t, rep, 2).transpose(1, 2)
              .reshape(b * h, s, n) for t in (bm, cm))
    y, hf = ssd_scan_plain(xdt, la, bf, cf, chunk=chunk)
    y = y.reshape(b, h, s, p).transpose(1, 2)
    if d is not None:
        y = y + x * d[None, None, :, None].to(x.dtype)
    return y, hf.reshape(b, h, p, n), (xdt, la, bf, cf)


# (b, s, h, p, g, n, chunk): the reference's kernel-test shapes, S = 90,
# a ragged chunk, the Mamba2 serving path's (80 heads of 64, N 128, chunk
# 256) and Jamba's (128 heads of 64, N 16, padded to 32 in bf16).
K5_SHAPES = [(2, 96, 4, 16, 2, 8, 32), (1, 64, 2, 8, 1, 16, 32),
             (1, 90, 2, 8, 1, 4, 32), (1, 100, 4, 64, 1, 128, 96),
             (1, 512, 80, 64, 1, 128, 256), (1, 512, 128, 64, 1, 16, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", K5_SHAPES)
def test_ssd_scan_kernel_matches_plain(dev, b, s, h, p, g, n, chunk, dtype):
    x, dt, a, bm, cm, d = _ssd_inputs(dev, b, s, h, p, g, n, dtype)
    before = k5.LAUNCHES["ssd_scan"]
    y, hf = ssd(x, dt, a, bm, cm, d, chunk=chunk)
    assert k5.LAUNCHES["ssd_scan"] == before + 1
    assert y.dtype == dtype and hf.dtype == torch.float32
    ry, rh, flat = _ssd_plain(x, dt, a, bm, cm, d, chunk)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(y.float(), ry.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(hf, rh, rtol=rtol, atol=atol)
    if s <= 128:         # the sequential oracle loops over S in Python
        gy, gh = ssd_scan_ref(*flat)
        gy = gy.reshape(b, h, s, p).transpose(1, 2) + \
            x * d[None, None, :, None].to(dtype)
        torch.testing.assert_close(y.float(), gy.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(hf, gh.reshape(b, h, p, n), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("chunk", [16, 32, 64, 96])
def test_ssd_scan_kernel_chunk_invariance(dev, chunk):
    x, dt, a, bm, cm, d = _ssd_inputs(dev, 1, 96, 2, 8, 1, 4, torch.float32)
    y, hf = ssd(x, dt, a, bm, cm, d, chunk=chunk)
    y96, h96 = ssd(x, dt, a, bm, cm, d, chunk=96)
    torch.testing.assert_close(y, y96, rtol=5e-4, atol=5e-5)
    torch.testing.assert_close(hf, h96, rtol=5e-4, atol=5e-5)


def test_ssd_scan_kernel_decay_stability_and_bitwise(dev):
    """dt x 100: every exp argument stays <= 0 and the output finite; two
    runs on the same inputs give the same bits."""
    x, dt, a, bm, cm, d = _ssd_inputs(dev, 1, 256, 2, 8, 1, 4, torch.float32)
    y, hf = ssd(x, dt * 100.0, a, bm, cm, d, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    x, dt, a, bm, cm, d = _ssd_inputs(dev, 1, 512, 80, 64, 1, 128,
                                      torch.bfloat16)
    first = ssd(x, dt, a, bm, cm, d, chunk=256)
    for _ in range(3):
        again = ssd(x, dt, a, bm, cm, d, chunk=256)
        assert all(torch.equal(u, v) for u, v in zip(first, again,
                                                     strict=True))


# K5's bf16 kernel (the tensor cores) at the edges of its tiles: S of 1, 17,
# 63, 65, 255 and 257 (128-row query and 64-row key tiles, chunks cut
# short), P of 8 to 72 (a 64-column P tile, two at 72), N of 4 to 128
# (padded to 32, 64 or 128; N = 4 has no row on a 16-byte boundary), rep of
# 1, 2, 8 and 80.  (b, s, h, p, g, n, chunk).
K5_EDGES = [(1, 1, 80, 64, 1, 128, 256), (1, 17, 2, 8, 2, 16, 16),
            (1, 63, 4, 16, 2, 32, 32), (1, 65, 8, 32, 1, 64, 64),
            (1, 255, 80, 64, 1, 128, 256), (1, 257, 4, 64, 2, 128, 256),
            (2, 65, 2, 24, 2, 48, 32), (1, 257, 8, 40, 1, 100, 128),
            (1, 129, 2, 72, 1, 128, 64), (1, 90, 4, 8, 2, 4, 32)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", K5_EDGES)
def test_ssd_scan_bf16_tile_edges_match_plain_and_oracle(dev, b, s, h, p, g,
                                                         n, chunk):
    """K5's own output (before the op adds the D skip, whose bf16 sum can
    cancel y down to a few ulps of its size) against its plain version and
    the sequential oracle."""
    x, dt, a, bm, cm, _ = _ssd_inputs(dev, b, s, h, p, g, n, torch.bfloat16)
    _, _, (xdt, la, bf, cf) = _ssd_plain(x, dt, a, bm, cm, None, chunk)
    bg, cg = (t.transpose(1, 2).reshape(b * g, s, n) for t in (bm, cm))
    before = k5.LAUNCHES["ssd_scan"]
    y, hf = k5.ssd_scan(xdt, la, bg, cg, chunk=chunk, rep=h // g)
    assert k5.LAUNCHES["ssd_scan"] == before + 1
    rtol, atol = TOL[torch.bfloat16]
    for want_y, want_h in (ssd_scan_plain(xdt, la, bf, cf, chunk=chunk),
                           ssd_scan_ref(xdt, la, bf, cf)):
        torch.testing.assert_close(y.float(), want_y.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(hf, want_h, rtol=rtol, atol=atol)


# The f32 kernel at the same edges (64-row query and key tiles, a 64-column
# P tile, N padded to 32, 64 or 128), and with P = 10 and N = 7, whose rows
# are staged by plain loads and y stored an element at a time.
K5_F32_EDGES = K5_EDGES + [(1, 70, 2, 10, 1, 7, 32)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", K5_F32_EDGES)
def test_ssd_scan_f32_tile_edges_match_plain_and_oracle(dev, b, s, h, p, g, n,
                                                        chunk):
    """K5's f32 kernel's own output at the edges of its tiles against its
    plain version and the sequential oracle at the f32 tolerance."""
    x, dt, a, bm, cm, _ = _ssd_inputs(dev, b, s, h, p, g, n, torch.float32)
    _, _, (xdt, la, bf, cf) = _ssd_plain(x, dt, a, bm, cm, None, chunk)
    bg, cg = (t.transpose(1, 2).reshape(b * g, s, n) for t in (bm, cm))
    before = k5.LAUNCHES["ssd_scan"]
    y, hf = k5.ssd_scan(xdt, la, bg, cg, chunk=chunk, rep=h // g)
    assert k5.LAUNCHES["ssd_scan"] == before + 1
    rtol, atol = TOL[torch.float32]
    for want_y, want_h in (ssd_scan_plain(xdt, la, bf, cf, chunk=chunk),
                           ssd_scan_ref(xdt, la, bf, cf)):
        torch.testing.assert_close(y, want_y, rtol=rtol, atol=atol)
        torch.testing.assert_close(hf, want_h, rtol=rtol, atol=atol)


def test_ssd_scan_f32_off_a_16_byte_boundary_keeps_its_bits(dev):
    """f32 inputs that start off a 16-byte boundary are staged by plain
    loads instead of cp.async: the output is the bits of the same values on
    aligned storage (three chunks, so the inter-chunk term runs too)."""
    x, dt, a, bm, cm, _ = _ssd_inputs(dev, 1, 129, 4, 64, 1, 128,
                                      torch.float32)
    _, _, (xdt, la, _, _) = _ssd_plain(x, dt, a, bm, cm, None, 64)
    bg, cg = (t.transpose(1, 2).reshape(1, 129, 128).contiguous()
              for t in (bm, cm))
    want = k5.ssd_scan(xdt.contiguous(), la, bg, cg, chunk=64, rep=4)
    got = k5.ssd_scan(_shifted(xdt), la, _shifted(bg), _shifted(cg),
                      chunk=64, rep=4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_scan_f32_path_shape_is_bitwise(dev):
    """The f32 kernel at the serving path's shape (two chunks of 256): two
    runs on the same inputs give the same bits."""
    x, dt, a, bm, cm, _ = _ssd_inputs(dev, 1, 512, 80, 64, 1, 128,
                                      torch.float32)
    _, _, (xdt, la, _, _) = _ssd_plain(x, dt, a, bm, cm, None, 256)
    bg, cg = (t.transpose(1, 2).reshape(1, 512, 128) for t in (bm, cm))
    first = k5.ssd_scan(xdt, la, bg, cg, chunk=256, rep=80)
    for _ in range(3):
        again = k5.ssd_scan(xdt, la, bg, cg, chunk=256, rep=80)
        assert all(torch.equal(u, v) for u, v in zip(first, again,
                                                     strict=True))


def test_ssd_scan_bf16_needs_16_byte_aligned_inputs(dev):
    """The bf16 kernel copies 16-byte pieces: an input that starts off a
    16-byte boundary raises instead of launching."""
    flat = torch.zeros(2 * 16 * 8 + 1, dtype=torch.bfloat16, device=dev)
    xdt = flat[1:].view(2, 16, 8)
    assert xdt.is_contiguous()
    la = torch.zeros((2, 16), device=dev)
    bc = torch.zeros((2, 16, 16), dtype=torch.bfloat16, device=dev)
    before = k5.LAUNCHES["ssd_scan"]
    with pytest.raises(ValueError, match="16-byte"):
        k5.ssd_scan(xdt, la, bc, bc)
    assert k5.LAUNCHES["ssd_scan"] == before
    k5.ssd_scan(xdt.clone(), la, bc, bc)
    assert k5.LAUNCHES["ssd_scan"] == before + 1


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "ssd_scan_mma_kernel"), (torch.float32,
                                              "ssd_scan_f32_kernel<")])
def test_ssd_scan_launches_the_kernel_of_its_dtype(dev, dtype, kernel):
    """bf16 on the tensor cores, f32 on the CUDA cores."""
    x, dt, a, bm, cm, d = _ssd_inputs(dev, 1, 64, 4, 64, 1, 128, dtype)
    names = _device_kernels(lambda: ssd(x, dt, a, bm, cm, d, chunk=32))
    assert [n for n in names if kernel in n], names


def test_ssd_scan_kernel_raises_instead_of_falling_back(dev):
    xdt = torch.zeros((2, 16, 8), dtype=torch.float64, device=dev)
    la = torch.zeros((2, 16), device=dev)
    with pytest.raises(TypeError, match="f32 or bf16"):
        k5.ssd_scan(xdt, la, xdt, xdt)
    xdt = torch.zeros((2, 16, 8), device=dev)
    bc = torch.zeros((2, 16, 256), device=dev)
    with pytest.raises(ValueError, match="N=256"):
        k5.ssd_scan(xdt, la, bc, bc)
    # The backward compiles P up to 64: a forward that autograd would need
    # it for raises before it launches, and the backward's wrapper runs on
    # CUDA tensors only (the CPU's is the plain version).
    xw = torch.zeros((2, 16, 72), device=dev, requires_grad=True)
    bc = torch.zeros((2, 16, 8), device=dev)
    before = dict(k5.LAUNCHES)
    with pytest.raises(ValueError, match="P=72"):
        k5.ssd_scan(xw, la, bc, bc)
    with pytest.raises(ValueError, match="P=72"):
        k5.ssd_scan_bwd(xw.detach(), la, bc, bc, xw.detach(), None)
    with pytest.raises(ValueError, match="cuda"):
        k5.ssd_scan_bwd(*(t.cpu() for t in (xdt, la, xdt, xdt, xdt)), None)
    assert k5.LAUNCHES == before


# ---------------------------------------------------- K5's backward kernels
#: K4's gradient tolerance (chip_smoke.GRAD_TOL): the backward sums its
#: products in another order than the plain version's matrix products.
GRAD_TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _ssd_bwd_case(dev, bh, s, p, g, n, dtype, seed=40, la_floor=None):
    """(xdt, la, b, c, dy, dstate) on the kernel's layout, drawn on the
    card: la = dt a as ``_ssd_inputs`` draws them, scaled so that its
    steepest step is ``la_floor`` where given."""
    xdt = _rand((bh, s, p), dtype, dev, seed)
    dt = _rand((bh, s), torch.float32, dev, seed + 1).abs() * 0.1 + 0.01
    a = -_rand((bh,), torch.float32, dev, seed + 2).abs() - 0.1
    la = dt * a[:, None]
    if la_floor is not None:
        la = la * (la_floor / la.min())
    bm, cm = (_rand((g, s, n), dtype, dev, seed + i) for i in (3, 4))
    dy = _rand((bh, s, p), dtype, dev, seed + 5)
    dstate = _rand((bh, p, n), torch.float32, dev, seed + 6)
    return xdt, la, bm, cm, dy, dstate


def _grad_close(got, want, dtype):
    rtol, atol = GRAD_TOL[dtype]
    for name, g, w in zip(("dxdt", "dla", "db", "dc"), got, want,
                          strict=True):
        assert g.dtype == w.dtype, name
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol, msg=lambda m, n=name: f"{n}: {m}")


# (bh, s, p, g, n, chunk): the reference's kernel-test shapes, a ragged
# last chunk and tile edges (S 1, 63, 65, 129; P 8, 10, 40, 64; N 4, 7, 48,
# 100), Mamba2-2.7B's training shape (80 heads of 64, one group of N 128,
# S 1024 in chunks of 256) and Jamba's (128 heads of 64, N 16).
K5_BWD_SHAPES = [(8, 96, 16, 2, 8, 32), (2, 64, 8, 1, 16, 32),
                 (2, 90, 8, 1, 4, 32), (4, 1, 64, 1, 128, 256),
                 (4, 63, 10, 2, 7, 32), (4, 65, 40, 1, 48, 64),
                 (6, 129, 64, 3, 100, 64), (4, 300, 64, 1, 128, 256),
                 (80, 1024, 64, 1, 128, 256), (128, 512, 64, 1, 16, 256)]


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,p,g,n,chunk", K5_BWD_SHAPES)
def test_ssd_scan_bwd_kernel_matches_plain(dev, bh, s, p, g, n, chunk, dtype,
                                           with_dstate):
    xdt, la, bm, cm, dy, dstate = _ssd_bwd_case(dev, bh, s, p, g, n, dtype)
    dstate = dstate if with_dstate else None
    before = k5.LAUNCHES["ssd_scan_bwd"]
    got = k5.ssd_scan_bwd(xdt, la, bm, cm, dy, dstate, chunk=chunk,
                          rep=bh // g)
    torch.cuda.synchronize()
    assert k5.LAUNCHES["ssd_scan_bwd"] == before + 1
    want = ssd_scan_bwd_plain(xdt, la, bm, cm, dy, dstate, chunk=chunk,
                              rep=bh // g)
    _grad_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_kernel_at_steep_decays(dev, dtype):
    """la down to -50 a step: the kernel within GRAD_TOL of the plain
    backward; in f32 also each gradient within 1e-4 of the f64
    recurrence's, as a relative Frobenius error (elementwise the f32
    chunked algorithm misses it there: tests/test_torch_mamba_scan_bwd.py)."""
    xdt, la, bm, cm, dy, dstate = _ssd_bwd_case(dev, 4, 300, 64, 1, 128,
                                                dtype, la_floor=-50.0)
    got = k5.ssd_scan_bwd(xdt, la, bm, cm, dy, dstate, chunk=256, rep=4)
    _grad_close(got, ssd_scan_bwd_plain(xdt, la, bm, cm, dy, dstate,
                                        chunk=256, rep=4), dtype)
    if dtype == torch.float32:
        leaves = [t.double().requires_grad_(True)
                  for t in (xdt, la, bm, cm)]
        y, h = ssd_scan_ref(leaves[0], leaves[1],
                            *(torch.repeat_interleave(t, 4, 0)
                              for t in leaves[2:]))
        ((y * dy.double()).sum() + (h * dstate.double()).sum()).backward()
        for g, w in zip(got, (t.grad for t in leaves), strict=True):
            rel = torch.linalg.vector_norm(g.double() - w) \
                / torch.linalg.vector_norm(w)
            assert float(rel) <= 1e-4


# (bh, s, p, g, n, chunk): the chunk-parallel grid's edges: 16 and 64
# chunks (S 4096), head rows far below and above the card's 132 SMs, P 32
# and 48, N 16, 64 and 100, chunks of 64 and 128 with a ragged last one,
# and 2 to 8 groups.
K5_BWD_GRID_SHAPES = [(2, 4096, 64, 1, 128, 256), (3, 4096, 32, 3, 16, 64),
                      (264, 256, 32, 4, 16, 64), (8, 1000, 48, 2, 64, 128),
                      (160, 300, 64, 8, 100, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,p,g,n,chunk", K5_BWD_GRID_SHAPES)
def test_ssd_scan_bwd_kernel_grid_edges_match_plain(dev, bh, s, p, g, n,
                                                    chunk, dtype):
    xdt, la, bm, cm, dy, dstate = _ssd_bwd_case(dev, bh, s, p, g, n, dtype,
                                                seed=41)
    got = k5.ssd_scan_bwd(xdt, la, bm, cm, dy, dstate, chunk=chunk,
                          rep=bh // g)
    want = ssd_scan_bwd_plain(xdt, la, bm, cm, dy, dstate, chunk=chunk,
                              rep=bh // g)
    _grad_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_kernel_is_bitwise_over_repeats(dev, dtype):
    """Mamba2-2.7B's training shape: two runs, the same bits."""
    case = _ssd_bwd_case(dev, 80, 1024, 64, 1, 128, dtype)
    first = k5.ssd_scan_bwd(*case, chunk=256, rep=80)
    again = k5.ssd_scan_bwd(*case, chunk=256, rep=80)
    assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True))


def test_ssd_scan_bwd_bf16_needs_16_byte_aligned_inputs(dev):
    """The bf16 backward copies 16-byte pieces: an input that starts off a
    16-byte boundary raises instead of launching."""
    xdt, la, bm, cm, dy, _ = _ssd_bwd_case(dev, 2, 64, 16, 1, 16,
                                           torch.bfloat16)
    flat = torch.zeros(dy.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(dy.shape)
    shifted.copy_(dy)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = k5.LAUNCHES["ssd_scan_bwd"]
    with pytest.raises(ValueError, match="16-byte"):
        k5.ssd_scan_bwd(xdt, la, bm, cm, shifted, None, chunk=32, rep=2)
    assert k5.LAUNCHES["ssd_scan_bwd"] == before
    got = k5.ssd_scan_bwd(xdt, la, bm, cm, dy, None, chunk=32, rep=2)
    assert k5.LAUNCHES["ssd_scan_bwd"] == before + 1
    _grad_close(got, ssd_scan_bwd_plain(xdt, la, bm, cm, dy, None, chunk=32,
                                        rep=2), torch.bfloat16)


#: The backward's device kernels by dtype (the state passing, dla and
#: reduction kernels are shared).
K5_BWD_KERNELS = {
    torch.bfloat16: ("ssd_bwd_sums_mma_kernel<", "ssd_bwd_local_mma_kernel<",
                     "ssd_bwd_reduce_kernel<__nv_bfloat16>"),
    torch.float32: ("ssd_bwd_sums_kernel<", "ssd_bwd_local_kernel<",
                    "ssd_bwd_reduce_kernel<float>")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_launches_the_kernels_of_its_dtype(dev, dtype):
    """Each dtype's five kernels, and not the other dtype's or the last
    design's one-block-a-head-row ``ssd_scan_bwd_kernel``."""
    case = _ssd_bwd_case(dev, 4, 64, 64, 1, 128, dtype)
    names = _device_kernels(lambda: k5.ssd_scan_bwd(*case, chunk=32, rep=4))
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    for kernel in K5_BWD_KERNELS[dtype] + ("ssd_bwd_pass_kernel",
                                           "ssd_bwd_dla_kernel"):
        assert [n for n in names if kernel in n], (kernel, names)
    for kernel in K5_BWD_KERNELS[other] + ("ssd_scan_bwd_kernel",):
        assert not [n for n in names if kernel in n], (kernel, names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_launches_the_kernels_once(dev, dtype):
    """K5 under autograd: one forward and one backward launch, and the
    backward's chunk-local and reduction kernels among its device kernels.
    f32 through ``ssd``, the op the model calls, against autograd through
    the same route with K5's plain version in K5's place; bf16 through
    ``ssd_scan`` against the plain backward (a
    bf16 chain rule rounds each head's B and C gradient before the plain
    route sums them over the group, which the kernel does in f32)."""
    before = dict(k5.LAUNCHES)
    if dtype == torch.float32:
        x, dt, a, bm, cm, d = _ssd_inputs(dev, 2, 96, 4, 16, 2, 8, dtype)
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, bm, cm)]
        y, _ = ssd(leaves[0], leaves[1], a, leaves[2], leaves[3], d,
                   chunk=32)
        y.square().sum().backward()
        plain = [t.clone().requires_grad_(True) for t in (x, dt, bm, cm)]
        _ssd_plain(plain[0], plain[1], a, plain[2], plain[3], d,
                   32)[0].square().sum().backward()
        for got, want in zip(leaves, plain, strict=True):
            torch.testing.assert_close(got.grad, want.grad, rtol=1e-3,
                                       atol=1e-4)
    else:
        xdt, la, bm, cm, dy, _ = _ssd_bwd_case(dev, 8, 96, 16, 2, 8, dtype)
        leaves = [t.clone().requires_grad_(True) for t in (xdt, la, bm, cm)]
        y, _ = k5.ssd_scan(*leaves, chunk=32, rep=4)
        y.backward(dy)
        want = ssd_scan_bwd_plain(xdt, la, bm, cm, dy, None, chunk=32, rep=4)
        _grad_close([t.grad for t in leaves], want, dtype)
    assert k5.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    assert k5.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    case = _ssd_bwd_case(dev, 4, 64, 64, 1, 128, dtype)
    names = _device_kernels(lambda: k5.ssd_scan_bwd(*case, chunk=32, rep=4))
    assert [n for n in names if "ssd_bwd_local_" in n], names
    assert [n for n in names if "ssd_bwd_reduce_kernel" in n], names


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_mamba_train_grain_on_kernels_matches_plain_and_counts(dev, arch):
    """Reduced Mamba2 and Jamba in f32: one grain's loss and gradients on
    the kernel route against use_pallas=False; K5 launches its forward
    twice (forward and remat recompute) and its backward once per Mamba
    layer."""
    cfg = get_config(arch, reduced=True)
    model = Model(dataclasses.replace(cfg, use_pallas=None))
    plain = Model(dataclasses.replace(cfg, use_pallas=False))
    params = model.init(0)
    n_mamba = sum(s.mixer == "mamba" for s in cfg.layer_pattern) \
        * cfg.n_periods + sum(s.mixer == "mamba" for s in cfg.prefix_pattern)
    g = torch.Generator().manual_seed(26)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g).to(dev)
    batch = {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int(),
             "loss_mask": torch.ones((2, 64), device=dev)}
    before = dict(k5.LAUNCHES)
    (loss, _), grads = make_grain_grad_fn(model, compile_steps=False)(
        params, batch)
    assert {n: k5.LAUNCHES[n] - before[n] for n in before} == {
        "ssd_scan": 2 * n_mamba, "ssd_scan_bwd": n_mamba}
    (loss_p, _), grads_p = make_grain_grad_fn(plain, compile_steps=False)(
        params, batch)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_p), strict=True):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5)


def test_mamba_model_prefill_launches_k5_per_layer(dev):
    """The reduced mamba2-2.7b on the card: a prefill launches K5 once a
    layer and matches use_pallas=False; decode steps launch none."""
    cfg = get_config("mamba2-2.7b", reduced=True)
    model = Model(dataclasses.replace(cfg, use_pallas=None))
    plain = Model(dataclasses.replace(cfg, use_pallas=False))
    params = model.init(0)
    toks = torch.arange(32, device=dev)[None] % cfg.vocab_size
    before = k5.LAUNCHES["ssd_scan"]
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": toks}, last_pos=20)
        assert k5.LAUNCHES["ssd_scan"] == before + cfg.n_layers
        ref, ref_caches = plain.prefill(params, {"tokens": toks}, last_pos=20)
        torch.testing.assert_close(logits, ref, rtol=5e-4, atol=5e-5)
        torch.testing.assert_close(caches["periods"]["pos0"]["self"].state,
                                   ref_caches["periods"]["pos0"]["self"].state,
                                   rtol=5e-4, atol=5e-5)
        model.decode_step(params, caches, toks[:, :1], 21)
    assert k5.LAUNCHES["ssd_scan"] == before + cfg.n_layers


# ------------------------------------------------------------------- MoE
def test_moe_layer_on_the_card_matches_the_cpu(dev):
    """One reduced-width MoE layer (8 experts of 32, top-2, a shared
    expert) in f32: ``apply_moe`` (uniform and homogenized capacities that
    drop tokens) and ``apply_moe_dense`` on the card against the same
    weights and input on the CPU."""
    from repro_torch.models import moe

    cfg = get_config("qwen2-moe-a2.7b", reduced=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    p_cpu = moe.init_moe(gen, cfg)
    p_dev = {k: (v.to(dev) if isinstance(v, torch.Tensor)
                 else {kk: vv.to(dev) for kk, vv in v.items()})
             for k, v in p_cpu.items()}
    x = torch.randn((2, 24, cfg.d_model), generator=gen) * 0.5
    caps = moe.capacity_per_expert(
        48, dataclasses.replace(cfg.moe, capacity_factor=0.5),
        expert_perfs=np.linspace(4.0, 0.5, cfg.moe.n_routed), round_to=1)
    for capacities in (None, caps):
        want, want_aux = moe.apply_moe(p_cpu, cfg, x, capacities)
        got, aux = moe.apply_moe(p_dev, cfg, x.to(dev), capacities)
        torch.testing.assert_close(got.cpu(), want, rtol=5e-4, atol=5e-5)
        torch.testing.assert_close(aux.cpu(), want_aux, rtol=5e-4, atol=5e-5)
    want, _ = moe.apply_moe_dense(p_cpu, cfg, x)
    got, _ = moe.apply_moe_dense(p_dev, cfg, x.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_moe_models_prefill_on_kernels_matches_plain(dev, arch):
    """The reduced MoE model and the reduced Jamba on the card: a prefill
    launches K1 once an attention layer and K5 once a mamba layer, and
    matches use_pallas=False; a decode step launches neither."""
    cfg = get_config(arch, reduced=True)
    model = Model(dataclasses.replace(cfg, use_pallas=None))
    plain = Model(dataclasses.replace(cfg, use_pallas=False))
    params = model.init(0)
    specs = cfg.layer_pattern * cfg.n_periods
    n_attn = sum(s.mixer == "attn" for s in specs)
    toks = torch.arange(32, device=dev)[None] % cfg.vocab_size
    before = pf.LAUNCHES["prefill_flash"], k5.LAUNCHES["ssd_scan"]
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": toks}, last_pos=20)
        after = pf.LAUNCHES["prefill_flash"], k5.LAUNCHES["ssd_scan"]
        assert (after[0] - before[0], after[1] - before[1]) == (
            n_attn, len(specs) - n_attn)
        ref, _ = plain.prefill(params, {"tokens": toks}, last_pos=20)
        torch.testing.assert_close(logits, ref, rtol=5e-4, atol=5e-5)
        model.decode_step(params, caches, toks[:, :1], 21)
    assert (pf.LAUNCHES["prefill_flash"], k5.LAUNCHES["ssd_scan"]) == after


# ------------------------------------------ the remaining configs' paths
# K1 on Qwen2-VL's prefill (28 q heads padded to 32 over 4 KV heads: group
# 8, D 128) and SeamlessM4T's decoder prefill (16 heads, group 1, D 64).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,s", [(32, 4, 128, 512), (32, 4, 128, 129),
                                        (16, 16, 64, 512), (16, 16, 64, 100)])
def test_prefill_flash_at_the_remaining_configs_groups(dev, hq, hkv, d, s,
                                                       dtype):
    q = _rand((hq, s, d), dtype, dev, 1)
    k, v = _rand((hkv, s, d), dtype, dev, 2), _rand((hkv, s, d), dtype, dev, 3)
    before = pf.LAUNCHES["prefill_flash"]
    out, _, _ = pf.prefill_flash(q, k, v, group=hq // hkv)
    assert pf.LAUNCHES["prefill_flash"] == before + 1
    ref, _, _ = prefill_ref(q, k, v, group=hq // hkv)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


# K4 at SeamlessM4T-medium's shapes (16 heads of 64), non-causal: the
# encoder's self-attention (Sq = Skv = 512) and the decoder's training
# cross-attention (Sq 64 over Skv 512).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv", [(512, 512), (64, 512)])
def test_flash_attention_at_seamless_shapes_matches_plain(dev, sq, skv,
                                                          dtype):
    """Forward, dQ and dK/dV against the plain version and autograd
    through it: the forward at the dtype's tolerance, the gradients at
    GRAD_TOL (bf16 2e-2; f32 1e-3 / 1e-4); one launch of each kernel."""
    q, k, v = _k4_inputs(dev, 1, sq, skv, 16, 16, 64, dtype)
    dout = _rand(q.shape, dtype, dev, 31)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(*leaves, causal=False)
    grads = torch.autograd.grad(out, leaves, dout)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkdv": 1}
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, causal=False)
    ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)
    grtol, gatol = (1e-3, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    for name, g, r in zip("qkv", grads, ref_grads, strict=True):
        torch.testing.assert_close(g.float(), r.float(), rtol=grtol,
                                   atol=gatol, msg=f"d{name}")


def test_remaining_configs_prefill_on_kernels_matches_plain(dev):
    """The reduced Qwen2-VL (embeds input, M-RoPE streams that differ) and
    SeamlessM4T on the card: a prefill launches K1 once a decoder layer
    (and, for the enc-dec model, K4 once an encoder layer) and matches
    use_pallas=False."""
    for arch in ("qwen2-vl-7b", "seamless-m4t-medium"):
        cfg = get_config(arch, reduced=True)
        model = Model(dataclasses.replace(cfg, use_pallas=None))
        plain = Model(dataclasses.replace(cfg, use_pallas=False))
        params = model.init(0)
        if cfg.is_enc_dec:
            batch = {"src_embeds": _rand((1, 40, cfg.d_model), torch.float32,
                                         dev, 4),
                     "tgt_tokens": torch.arange(32, device=dev)[None]}
            n_k4 = cfg.encoder.n_layers
        else:
            pos = torch.arange(32, device=dev)[None, None].repeat(1, 3, 1)
            pos[0, 1, 4:13] = 4 + torch.arange(9, device=dev) // 3
            pos[0, 2, 4:13] = 4 + torch.arange(9, device=dev) % 3
            pos[0, 0, 4:13] = 4
            batch = {"embeds": _rand((1, 32, cfg.d_model), torch.float32,
                                     dev, 4), "positions": pos}
            n_k4 = 0
        before = pf.LAUNCHES["prefill_flash"], fa.LAUNCHES[
            "flash_attention_fwd"]
        with torch.no_grad():
            logits, _ = model.prefill(params, batch, last_pos=20)
            after = pf.LAUNCHES["prefill_flash"], fa.LAUNCHES[
                "flash_attention_fwd"]
            assert (after[0] - before[0], after[1] - before[1]) == (
                cfg.n_layers, n_k4), arch
            ref, _ = plain.prefill(params, batch, last_pos=20)
        torch.testing.assert_close(logits, ref, rtol=5e-4, atol=5e-5,
                                   msg=arch)


def test_mla_handoff_through_put_on_the_card(dev):
    """The reduced DeepSeek-V2 on the card: MLACache handoffs of shorter
    buckets (the prefix layer's through lane axis 0) through prefill +
    insert give the tokens of submit, and launch no kernel."""
    cfg = get_config("deepseek-v2-236b", reduced=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    model = Model(cfg)
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 255, n)] for n in (5, 11)]
    from repro_torch.serve import DecodeEngine, Request

    fed = DecodeEngine(model, params, max_batch=2, max_seq=32)
    a = [Request(i, list(p), 6) for i, p in enumerate(prompts)]
    for r in a:
        fed.submit(r)
    fed.run_until_drained()
    before = dict(pf.LAUNCHES), dict(fa.LAUNCHES)
    dec = DecodeEngine(model, params, max_batch=2, max_seq=32)
    pre = DecodeEngine(model, params, max_batch=2, max_seq=32)
    b = [Request(i, list(p), 6) for i, p in enumerate(prompts)]
    for r in b:
        dec.insert(pre.prefill(r))
    dec.run_until_drained()
    assert (dict(pf.LAUNCHES), dict(fa.LAUNCHES)) == before
    assert [r.out_tokens for r in a] == [r.out_tokens for r in b]


# ------------------------------------------------- the engine's compiled steps
def _logged(engine) -> list:
    """The engine's host logits, every decode step and prefill in call
    order."""
    seen = []
    decode, prefill = engine._decode_logits, engine._prefill_logits

    def dec(toks, pos):
        lg = decode(toks, pos)
        seen.append(lg.copy())
        return lg

    def pre(toks, last_pos):
        lg, caches = prefill(toks, last_pos)
        seen.append(lg.copy())
        return lg, caches

    engine._decode_logits, engine._prefill_logits = dec, pre
    return seen


def _serve_both(engine, prompts, new: int = 5) -> list[list[int]]:
    """The prompts through prefill + insert (two at a time), then again
    through ``submit``."""
    from repro_torch.serve import Request

    out = []
    reqs = [Request(i, list(p), new) for i, p in enumerate(prompts)]
    for i in range(0, len(reqs), engine.max_batch):
        handoffs = [engine.prefill(r) for r in reqs[i:i + engine.max_batch]]
        for h in handoffs:
            engine.insert(h)
        engine.run_until_drained()
    out += [r.out_tokens for r in reqs]
    reqs = [Request(i, list(p), new) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    return out + [r.out_tokens for r in reqs]


def test_rope_freqs_keep_their_bits_on_the_card(dev):
    """The frequencies built once on the card (and kept: the same tensor
    again) are the bits of the expression the model computed on every
    call."""
    from repro_torch.models.layers import rope_freqs

    for d in (64, 128, 192):
        for theta in (1e4, 1e6, 10000.1):
            exps = torch.arange(0, d, 2, dtype=torch.float32, device=dev) / d
            old = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                               device=dev), exps)
            new = rope_freqs(d, theta, dev)
            assert torch.equal(new, old)
            assert rope_freqs(d, theta, torch.device(dev)) is new


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b",
                                  "jamba-v0.1-52b", "qwen2-moe-a2.7b"])
def test_compiled_engine_is_the_eager_engine_bit_for_bit(dev, arch):
    """The reduced config on the card, f32: the engine's captured decode
    step and prefills (three prompts of bucket 16: warm-up, capture +
    replay, replay; one of bucket 32: warm-up) give the eager route's
    logits bit for bit and its tokens, and count the kernels' launches of
    every replay: K1 once an attention layer and K5 once a mamba layer a
    prefill, as the eager route counts them."""
    from repro_torch.serve import DecodeEngine, compiled

    cfg = dataclasses.replace(get_config(arch, reduced=True), use_pallas=None)
    model = Model(cfg)
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (5, 11, 7, 20)]
    runs = {}
    for flag in (True, False):
        engine = DecodeEngine(model, params, max_batch=2, max_seq=64,
                              compile_steps=flag)
        seen = _logged(engine)
        before = pf.LAUNCHES["prefill_flash"], k5.LAUNCHES["ssd_scan"]
        captures = compiled.STATS["captures"]
        tokens = _serve_both(engine, prompts)
        torch.cuda.synchronize()
        launched = (pf.LAUNCHES["prefill_flash"] - before[0],
                    k5.LAUNCHES["ssd_scan"] - before[1])
        runs[flag] = (tokens, seen, launched,
                      compiled.STATS["captures"] - captures, engine)
    fast, slow = runs[True], runs[False]
    assert fast[0] == slow[0]
    assert len(fast[1]) == len(slow[1]) > 20
    for a, b in zip(fast[1], slow[1]):
        assert np.array_equal(a, b)
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_pattern) * cfg.n_periods
    n_mamba = sum(s.mixer == "mamba" for s in cfg.layer_pattern) \
        * cfg.n_periods + sum(s.mixer == "mamba" for s in cfg.prefix_pattern)
    assert fast[2] == slow[2] == (4 * n_attn, 4 * n_mamba)
    engine = fast[4]
    assert fast[3] == 2                 # the decode step and bucket 16
    assert engine._decode.graph is not None
    assert engine._prefills[16].graph is not None
    assert engine._prefills[32].graph is None


def test_failed_capture_raises_instead_of_running_eagerly(dev):
    """A step that syncs the host runs as its eager warm-up, then its
    capture fails: the call raises with the step's name and CUDA's error,
    runs nothing eagerly, and so does the next call."""
    from repro_torch.serve import compiled

    ran = []

    def fn(x):
        ran.append(1)
        return x * float(x.sum().item())

    step = compiled.CompiledStep("sync-step", fn, dev)
    x = torch.arange(4.0, device=dev)
    assert torch.equal(step(x), x * 6.0)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture of sync-step failed"):
            step(x)
        assert step.graph is None
    assert len(ran) == 3                # the warm-up and two captures
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    # The card goes on: a kernel wrapper (which reads CUDA's last error)
    # launches, and plain ops run.
    k = _rand((2, 64, 128), torch.float32, dev)
    kc, vc = pf.cache_cast(k, k, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(kc, k.to(torch.bfloat16)) and torch.equal(kc, vc)


def test_capture_runs_without_cyclic_gc(dev):
    """A cyclic collection during a capture can free a dropped engine's
    graph, which CUDA forbids while a stream captures (it invalidated a
    later capture on the card): the capture runs with the collector off,
    and turns it back on."""
    import gc

    from repro_torch.serve import compiled

    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return x * 2

    step = compiled.CompiledStep("gc-step", fn, dev)
    x = torch.ones(4, device=dev)
    for _ in range(3):
        assert torch.equal(step(x), x * 2)
    assert seen == [True, False] and gc.isenabled()


def test_compiled_trainer_is_the_eager_trainer_bit_for_bit(dev):
    """Reduced Qwen2 in bf16, 2 HDP steps under a mid-step halving on both
    routes: the compiled route (the grain gradient captured at its second
    grain, the update at its second step, both replayed after) gives the
    eager route's losses, grad norms and parameters bit for bit, and K4's
    launches (the replays' counted as the eager calls') are the same."""
    from repro_torch.serve import compiled

    cfg = get_config("qwen2-1.5b", reduced=True, tp_pad_heads=8,
                     param_dtype="bfloat16", compute_dtype="bfloat16")
    model = Model(dataclasses.replace(cfg, use_pallas=None))
    runs = {}
    for flag in (True, False):
        before, captures = dict(fa.LAUNCHES), compiled.STATS["captures"]
        rep = Cluster("4:3:2:1").train(
            TrainJob(model, steps=2, grains=8, seq_len=64,
                     compile_steps=flag),
            scenario="halve:w0@1:25%")
        torch.cuda.synchronize()
        runs[flag] = (
            [(p.metrics["loss"], p.metrics["grad_norm"]) for p in rep.phases],
            tree_leaves(rep.artifact.state.params),
            {n: fa.LAUNCHES[n] - before[n] for n in before},
            compiled.STATS["captures"] - captures, rep.artifact)
    fast, slow = runs[True], runs[False]
    assert fast[0] == slow[0]
    assert all(torch.equal(a, b) for a, b in zip(fast[1], slow[1],
                                                 strict=True))
    assert fast[2] == slow[2] == {
        "flash_attention_fwd": 2 * 16 * cfg.n_layers,
        "flash_attention_bwd_dq": 16 * cfg.n_layers,
        "flash_attention_bwd_dkdv": 16 * cfg.n_layers}
    assert fast[3] == 2 and slow[3] == 0
    (grain,) = fast[4]._grad_fn.steps
    assert grain.graph is not None and fast[4]._update.graph is not None


def test_compiled_train_single_is_eager_bit_for_bit(dev):
    """``train_single`` on the card, reduced Qwen2 in bf16, 3 steps: the
    compiled whole step (forward, backward and AdamW in one graph, the
    state written in place) gives the eager route's history and parameters
    bit for bit, with the same K4 launches."""
    from repro_torch.train import train_single

    cfg = get_config("qwen2-1.5b", reduced=True,
                     param_dtype="bfloat16", compute_dtype="bfloat16")
    model = Model(dataclasses.replace(cfg, use_pallas=None))
    g = torch.Generator().manual_seed(26)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g).to(dev)
    batch = {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int(),
             "loss_mask": torch.ones((2, 64), device=dev)}
    runs = {}
    for flag in (True, False):
        before = dict(fa.LAUNCHES)
        state, hist = train_single(model, 3, lambda s: batch, log_every=1,
                                   compile_steps=flag)
        torch.cuda.synchronize()
        runs[flag] = (hist, tree_leaves(state),
                      {n: fa.LAUNCHES[n] - before[n] for n in before})
    fast, slow = runs[True], runs[False]
    assert fast[0] == slow[0] and len(fast[0]) == 3
    assert all(torch.equal(a, b) for a, b in zip(fast[1], slow[1],
                                                 strict=True))
    assert fast[2] == slow[2] == {
        "flash_attention_fwd": 3 * 2 * cfg.n_layers,
        "flash_attention_bwd_dq": 3 * cfg.n_layers,
        "flash_attention_bwd_dkdv": 3 * cfg.n_layers}


def _arch_batch(cfg, dev, seq: int, tgt: int | None = None) -> dict:
    """A bf16 batch of ``cfg``'s input mode: embeds with M-RoPE streams that
    differ (text, a 3 x 3 image block, text), or ``seq`` source frames and
    ``tgt`` target tokens."""
    g = torch.Generator().manual_seed(27)
    if cfg.is_enc_dec:
        toks = torch.randint(0, cfg.vocab_size, (2, tgt + 1), generator=g)
        return {"src_embeds": (torch.randn((2, seq, cfg.d_model), generator=g)
                               * 0.5).to(dev, torch.bfloat16),
                "tgt_tokens": toks[:, :-1].int().to(dev),
                "targets": toks[:, 1:].int().to(dev),
                "loss_mask": torch.ones((2, tgt), device=dev)}
    t = list(range(3)) + [3] * 9
    h = list(range(3)) + [3 + i // 3 for i in range(9)]
    w = list(range(3)) + [3 + i % 3 for i in range(9)]
    rest = list(range(6, 6 + seq - 12))
    pos = torch.tensor([[t + rest, h + rest, w + rest]] * 2,
                       dtype=torch.int32)
    return {"embeds": torch.randn((2, seq, cfg.d_model), generator=g).to(
                dev, torch.bfloat16),
            "positions": pos.to(dev),
            "targets": torch.randint(0, cfg.vocab_size, (2, seq),
                                     generator=g).int().to(dev),
            "loss_mask": torch.ones((2, seq), device=dev)}


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-medium"])
def test_compiled_train_single_embeds_and_enc_dec_bit_for_bit(dev, arch):
    """``train_single`` on the card on the reduced Qwen2-VL (embeds, M-RoPE
    streams that differ; 3 steps) and SeamlessM4T (two target lengths in
    turn, two graphs; 4 steps), bf16 on K4: the compiled route's history,
    state and K4 launches the eager route's, bit for bit."""
    from repro_torch.serve import compiled
    from repro_torch.train import train_single

    cfg = get_config(arch, reduced=True, param_dtype="bfloat16",
                     compute_dtype="bfloat16")
    model = Model(dataclasses.replace(cfg, use_pallas=None))
    if cfg.is_enc_dec:
        shapes = [_arch_batch(cfg, dev, 48, 32), _arch_batch(cfg, dev, 48, 8)]
        batches = [shapes[i % 2] for i in range(4)]
    else:
        batches = [_arch_batch(cfg, dev, 48)] * 3
    runs = {}
    for flag in (True, False):
        before, captures = dict(fa.LAUNCHES), compiled.STATS["captures"]
        state, hist = train_single(model, len(batches), lambda s: batches[s],
                                   log_every=1, compile_steps=flag)
        torch.cuda.synchronize()
        runs[flag] = (hist, tree_leaves(state),
                      {n: fa.LAUNCHES[n] - before[n] for n in before},
                      compiled.STATS["captures"] - captures)
    fast, slow = runs[True], runs[False]
    assert fast[0] == slow[0] and len(fast[0]) == len(batches)
    assert all(torch.equal(a, b) for a, b in zip(fast[1], slow[1],
                                                 strict=True))
    n = (cfg.encoder.n_layers + 2 * cfg.n_layers if cfg.is_enc_dec
         else cfg.n_layers) * len(batches)
    assert fast[2] == slow[2] == {"flash_attention_fwd": 2 * n,
                                  "flash_attention_bwd_dq": n,
                                  "flash_attention_bwd_dkdv": n}
    assert fast[3] == (2 if cfg.is_enc_dec else 1) and slow[3] == 0


#: K4's shapes on the training paths of Qwen2-VL-7B (q (32, 1024, 128)
#: over k/v (4, 1024, 128), causal) and SeamlessM4T-medium (16 heads of 64:
#: the encoder's self-attention over 512 frames, non-causal; the decoder's,
#: causal; the cross-attention of 64 target tokens over 512 frames):
#: (Sq, Skv, Hq, Hkv, D, causal).
K4_TRAIN_PATH_SHAPES = [(1024, 1024, 32, 4, 128, True),
                        (512, 512, 16, 16, 64, False),
                        (512, 512, 16, 16, 64, True),
                        (64, 512, 16, 16, 64, False)]


@pytest.mark.parametrize("sq,skv,hq,hkv,d,causal", K4_TRAIN_PATH_SHAPES)
def test_flash_attention_bf16_training_shapes_match_autograd(
        dev, sq, skv, hq, hkv, d, causal):
    """bf16 forward, dQ and dK/dV at the training paths' shapes against the
    plain version and autograd through it, at the bf16 tolerance; one
    launch of each kernel."""
    q, k, v = _k4_inputs(dev, 1, sq, skv, hq, hkv, d, torch.bfloat16)
    dout = _rand(q.shape, torch.float32, dev, 28).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(*leaves, causal=causal, group=hq // hkv)
    grads = torch.autograd.grad(out, leaves, dout)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkdv": 1}
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, causal=causal, group=hq // hkv)
    ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    for name, g, r in zip("qkv", grads, ref_grads, strict=True):
        assert g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g.float(), r.float(), rtol=2e-2,
                                   atol=2e-2, msg=f"d{name}")


@pytest.mark.parametrize("overlap", [False, True])
def test_wallclock_unit_op_graph_route_is_eager_bitwise(dev, overlap):
    """The wall-clock unit op on the card: on the compiled route every op
    of a chain is one graph launch (calibration's and each grain's, after
    each graph's capture), and each grain's chain ends in the eager
    route's bits."""
    from repro_torch.core import SimWorker, WallclockBackend
    from repro_torch.serve import compiled

    replays0, captures0 = compiled.STATS["replays"], compiled.STATS["captures"]
    fast = WallclockBackend(side=128, overlap=overlap, calibration_reps=8)
    # Three graphs captured, each replayed once as it is; then 8 unit ops.
    assert compiled.STATS["captures"] - captures0 == 3
    assert compiled.STATS["replays"] - replays0 == 3 + 8
    slow = WallclockBackend(side=128, overlap=overlap, calibration_reps=8,
                            compile_op=False)
    assert fast._chains[0] is not None and slow._chains == [None]
    for wb in (fast, slow):     # in overlap mode, the worker's own chain
        h = wb.launch(None, SimWorker("w0", 1.0), 0, 1.0, 0.0)
        if h.done is not None:
            h.done.synchronize()
    for grain, perf in enumerate((1.0, 2.0, 3.0, 12 / 7), start=1):
        ends = []
        for wb in (fast, slow):
            replays0 = compiled.STATS["replays"]
            h = wb.launch(None, SimWorker("w0", perf), grain, 1.0, 0.0)
            if h.done is not None:
                h.done.synchronize()
            torch.cuda.synchronize()
            assert compiled.STATS["replays"] - replays0 == (
                h.k if wb is fast else 0)
            ends.append(h.value.clone())
        assert torch.equal(ends[0], ends[1])


@pytest.mark.parametrize("size", [7, 1 << 12])
def test_adamw_update_in_slices_keeps_its_bits_on_the_card(dev, monkeypatch,
                                                           size):
    """AdamW on the card with large leaves updated a slice at a time
    (``adamw.SLICE``): the same parameters and moments, bit for bit, as
    the whole-leaf update, bf16 parameters over f32 moments."""
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.optim import adamw as adamw_mod

    shapes = [(3, 4096, 5), (70001,), (2, 64)]

    def run(slice_size):
        monkeypatch.setattr(adamw_mod, "SLICE", slice_size)
        p = [_rand(s, torch.bfloat16, dev, 30 + i)
             for i, s in enumerate(shapes)]
        g = [_rand(s, torch.bfloat16, dev, 40 + i)
             for i, s in enumerate(shapes)]
        opt = {"m": [_rand(s, torch.float32, dev, 50 + i) * 0.1
                     for i, s in enumerate(shapes)],
               "v": [_rand(s, torch.float32, dev, 60 + i).abs() * 1e-3
                     for i, s in enumerate(shapes)],
               "step": torch.tensor(4, dtype=torch.int32, device=dev)}
        new_p, new_opt, _ = adamw_update(g, opt, p, AdamWConfig(),
                                         in_place=True)
        torch.cuda.synchronize()
        return new_p + new_opt["m"] + new_opt["v"]

    whole, sliced = run(1 << 26), run(size)
    assert all(torch.equal(a, b) for a, b in zip(whole, sliced, strict=True))


def test_capture_returns_cached_blocks_first(dev, monkeypatch):
    """A graph's private pool cannot take the blocks the allocator keeps
    cached for eager tensors: a capture hands them back to the device
    before it begins, so a step captured after a large eager phase still
    fits (a training step's capture ran out of memory beside 46 GiB of
    cached, unused blocks)."""
    from repro_torch.serve import compiled

    calls = []
    empty, begin = torch.cuda.empty_cache, torch.cuda.CUDAGraph.capture_begin

    def empty_cache():
        calls.append("empty_cache")
        empty()

    def capture_begin(self, *args, **kwargs):
        calls.append("capture_begin")
        return begin(self, *args, **kwargs)

    monkeypatch.setattr(torch.cuda, "empty_cache", empty_cache)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
    step = compiled.CompiledStep("cache-step", lambda x: x * 2, dev)
    x = torch.ones(4, device=dev)
    for _ in range(3):
        assert torch.equal(step(x), x * 2)
    assert step.graph is not None
    assert calls == ["empty_cache", "capture_begin"]


# ---------------------------------------- the shared backend's transport
_SHARED_WORKER = """
import hashlib, json, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from repro_torch.launch import shared_pg
rank, world, port, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.cuda.set_device(0)
if mode == "unbuildable":
    def refuse(*args, **kwargs):
        raise RuntimeError("nvcc refused")
    shared_pg.build_library = refuse
    shared_pg.load_library.cache_clear()
shared_pg.register(slot_bytes=4096)
dist.init_process_group("shared", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
pg = dist.group.WORLD
if mode == "unbuildable":
    try:
        dist.all_reduce(torch.ones(8, device="cuda"))
        print(json.dumps({"raised": False}))
    except RuntimeError as e:
        print(json.dumps({"raised": "nvcc refused" in str(e),
                          "memory": shared_pg.MEMORY}))
    sys.exit(0)


def data(r, shape, dt, seed):
    rng = np.random.default_rng(1000 * seed + r)
    if dt == torch.int64:
        return torch.from_numpy(rng.integers(-1000, 1000, size=shape))
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dt)


def run(dev):
    # every collective on `dev`: the results, on the host
    res = {}
    for seed, dt in enumerate((torch.float32, torch.bfloat16, torch.float16,
                               torch.int64)):
        x = data(rank, (33, 129), dt, seed).to(dev)
        for op, rop in (("sum", dist.ReduceOp.SUM),
                        ("max", dist.ReduceOp.MAX)):
            y = x.clone()
            dist.all_reduce(y, op=rop)
            res[f"ar-{op}-{dt}"] = y
            y = torch.empty(11, 129, dtype=dt, device=dev)
            dist.reduce_scatter_tensor(y, x[:11 * world].contiguous(), op=rop)
            res[f"rs-{op}-{dt}"] = y
        y = torch.empty(world * 33, 129, dtype=dt, device=dev)
        dist.all_gather_into_tensor(y, x)
        res[f"ag-{dt}"] = y
        y = x.clone()
        dist.broadcast(y, src=world - 1)
        res[f"bc-{dt}"] = y
        rows = [[(r * 3 + j * 5) % 4 * 9 for j in range(world)]
                for r in range(world)]
        send = data(rank, (sum(rows[rank]), 5), dt, seed + 20).to(dev)
        recv = [rows[j][rank] for j in range(world)]
        y = torch.empty(sum(recv), 5, dtype=dt, device=dev)
        dist.all_to_all_single(y, send, recv, rows[rank])
        res[f"a2a-{dt}"] = y
    x = data(rank, (29, 7), torch.float32, 9).to(dev)
    y = x.t().clone().t()                     # a non-contiguous view
    dist.all_reduce(y)
    res["ar-noncontig"] = y
    res["funcol-ag"] = funcol.wait_tensor(funcol.all_gather_tensor(x, 1, pg))
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in res.items()}


def bits(t):
    t = t.contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


for k in shared_pg.LAUNCHES:
    shared_pg.LAUNCHES[k] = 0
on_card, on_cpu = run("cuda"), run("cpu")
equal = {k: torch.equal(bits(on_card[k]), bits(on_cpu[k])) for k in on_card}
digests = {k: hashlib.sha256(bits(v).numpy().tobytes()).hexdigest()
           for k, v in on_card.items()}
# a probe of mixed devices
try:
    dist.all_gather_into_tensor(torch.empty(world * 3, device="cuda"),
                                torch.ones(3))
    mixed = False
except ValueError:
    mixed = True
launches = dict(shared_pg.LAUNCHES)
memory = dict(shared_pg.MEMORY)
dist.destroy_process_group()
print(json.dumps({"equal": equal, "digests": digests, "mixed": mixed,
                  "launches": launches, "memory": memory,
                  "after": dict(shared_pg.MEMORY)}))
"""


def _shared_ranks(mode: str, world: int = 2) -> list[dict]:
    import json
    import os
    import pathlib
    import socket
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SHARED_WORKER, str(r), str(world), str(port),
         mode], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=root) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs, strict=True):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


def test_shared_backend_on_the_card_is_its_cpu_route(dev):
    """Two processes on the card over the ``"shared"`` backend (CUDA IPC
    mailboxes, a 4 KiB slot: every tensor in chunks): each collective's
    output bitwise its CPU route's on the same inputs, in f32, bf16, f16
    and int64, sum and max, uneven all-to-all and a non-contiguous input;
    the reductions the same on both ranks; both kernels launched; a call
    that mixes devices raises; no mailbox left after
    ``destroy_process_group``."""
    ranks = _shared_ranks("routes")
    for res in ranks:
        assert all(res["equal"].values()), [
            k for k, v in res["equal"].items() if not v]
        assert res["mixed"]
        assert res["launches"]["shared_reduce"] > 0
        assert res["launches"]["shared_gather"] > 0
        assert res["memory"]["cuda"] == 2 * 4096
        assert res["after"] == {"cuda": 0, "cpu": 0}
    for k, d in ranks[0]["digests"].items():
        if k.startswith(("ar", "ag", "bc", "funcol")):
            assert ranks[1]["digests"][k] == d, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("n,count,shift", [(2, 1 << 20, 0), (4, 4099, 0),
                                           (8, 777, 3), (3, 1 << 16, 1)])
def test_shared_reduce_kernel_is_its_plain_version(dev, dtype, op, n, count,
                                                   shift):
    """``shared_reduce_kernel`` bitwise ``reduce_plain`` (rank order, f32
    accumulation, one rounding), with 16-byte loads (aligned) and scalar
    loads (``shift`` elements off the boundary)."""
    from repro_torch.launch import shared_pg

    slots = [_rand((count + shift,), dtype, dev, 70 + r)[shift:]
             for r in range(n)]
    out = torch.empty(count + shift, dtype=dtype, device=dev)[shift:]
    before = shared_pg.LAUNCHES["shared_reduce"]
    shared_pg.shared_reduce(slots, out, op)
    torch.cuda.synchronize()
    assert shared_pg.LAUNCHES["shared_reduce"] == before + 1
    want = shared_pg.reduce_plain([s.cpu() for s in slots], op)
    assert torch.equal(out.cpu().view(torch.int16 if dtype == torch.bfloat16
                                      else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def test_shared_gather_kernel_is_its_plain_version(dev):
    """``shared_gather_kernel`` copies each segment whole, aligned or not."""
    from repro_torch.launch import shared_pg

    src = [torch.randint(0, 255, (n,), dtype=torch.uint8, device=dev)
           for n in (1 << 20, 4099, 17, 0)]
    dst = [torch.zeros(n + 3, dtype=torch.uint8, device=dev)[3:]
           for n in (1 << 20, 4099, 17, 0)]
    shared_pg.shared_gather(src, dst)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(src, dst, strict=True))


def test_shared_backend_raises_without_its_library(dev):
    """A CUDA tensor's collective with the library unbuildable raises; it
    does not fall back to the host, and no mailbox is held."""
    for res in _shared_ranks("unbuildable"):
        assert res["raised"] is True
        assert res["memory"]["cuda"] == 0
