"""The port's CUDA kernels on the card: each against its plain version, the
launch counters, and dispatch that raises instead of falling back.

Marked ``cuda``: without a CUDA device they skip (a CUDA kernel has no
interpret mode).  On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
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
