"""The port's CUDA kernels on the card: each against its plain version, the
launch counters, and dispatch that raises instead of falling back.

Marked ``cuda``: without a CUDA device they skip (a CUDA kernel has no
interpret mode).  On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from repro_torch.cluster import Cluster, MatmulJob
from repro_torch.configs import get_config
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.prefill import prefill as pf
from repro_torch.kernels.prefill.ops import prefill_attention
from repro_torch.kernels.prefill.ref import prefill_ref
from repro_torch.models import Model

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,s", [(2, 2, 16, 32), (4, 2, 16, 48),
                                        (16, 2, 128, 100), (8, 1, 64, 300)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (2, 96, 70), (100, 70, 36),
                                   (513, 129, 257), (2, 1000, 1000)])
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
