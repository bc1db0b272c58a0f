"""Port parity: the matmul op of ``repro_torch`` (kernel K3's route) against
the JAX package's, on the same numpy inputs.

The JAX op runs its Pallas kernel in interpret mode with the blocks of
``tests/test_kernels.py``; the port runs on the CPU, where its kernel
wrapper takes the plain version.  Tolerances are the reference's: f32 rtol
5e-4 / atol 5e-5, bf16 2e-2.  The plain version is also held to bitwise
row-slice invariance, which the TDA's 2-row grains rely on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul.ops import matmul as jax_matmul
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.matmul.ref import matmul_ref

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=5e-4, atol=5e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, m, k, n):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, k)).astype(np.float32),
            r.standard_normal((k, n)).astype(np.float32))


def _check(x, y, dtype, blocks):
    bm, bn, bk = blocks
    jdt = getattr(jnp, dtype)
    want = jax_matmul(jnp.asarray(x, jdt), jnp.asarray(y, jdt),
                      use_pallas=True, interpret=True,
                      block_m=bm, block_n=bn, block_k=bk)
    before = dict(mm.LAUNCHES)
    got = matmul(torch.from_numpy(x).to(TORCH_DT[dtype]),
                 torch.from_numpy(y).to(TORCH_DT[dtype]))
    assert mm.LAUNCHES == before          # the CPU takes the plain version
    assert got.dtype == TORCH_DT[dtype] and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "m,k,n", [(8, 128, 128), (256, 512, 256), (100, 70, 36), (1, 1, 1),
              (513, 129, 257)])
def test_matmul_matches_jax_kernel(m, k, n, dtype):
    _check(*_inputs(m * 7 + k * 3 + n, m, k, n), dtype, (64, 128, 128))


@pytest.mark.parametrize("blocks", [(8, 128, 128), (32, 256, 64), (64, 128, 512)])
def test_matmul_matches_jax_block_sweep(blocks):
    """The JAX kernel's block sweep: the port has one compiled tile, so
    every JAX blocking must agree with the same port product."""
    _check(*_inputs(5, 96, 160, 192), "float32", blocks)


def _rand_mkn(seed: int) -> tuple[int, int, int, int]:
    r = np.random.default_rng(seed)
    m, k, n = (int(v) for v in r.integers(1, 97, 3))
    return m, k, n, seed


@pytest.mark.parametrize(
    "m,k,n,seed",
    [_rand_mkn(s) for s in range(14)]
    + [(1, 1, 1, 0), (96, 96, 96, 1), (1, 96, 1, 2), (96, 1, 96, 3),
       (95, 33, 17, 2**31), (64, 32, 96, 123456789)],
)
def test_matmul_matches_jax_any_shape(m, k, n, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32)
    y = r.standard_normal((k, n)).astype(np.float32)
    _check(x, y, "float32", (32, 128, 128))


@pytest.mark.parametrize("m,k,n", [(120, 48, 36), (25, 8, 8), (128, 1000, 128),
                                   (500, 500, 500)])
def test_plain_version_is_row_slice_invariant(m, k, n):
    """Every 2-row slice (even offsets, the TDA's grains, and odd ones) of
    the plain product equals the product of those rows, bit for bit —
    including (128, 1000, 128) and (500, 500, 500), where MKL's sgemm
    is not row-invariant with several threads."""
    x, y = (torch.from_numpy(a) for a in _inputs(m + n, m, k, n))
    full = matmul_ref(x, y)
    for lo in range(0, m - 1, 1 if m < 200 else 3):
        assert torch.equal(matmul_ref(x[lo:lo + 2], y), full[lo:lo + 2]), lo


def test_plain_version_bf16_accumulates_in_f32():
    x, y = _inputs(9, 33, 300, 17)
    xb, yb = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
    got = matmul_ref(xb, yb)
    want = (xb.double() @ yb.double()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **TOL["bfloat16"])


def test_dispatch_and_validation():
    x, y = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 5))
    assert torch.equal(matmul(x, y), matmul_ref(x, y))
    # A non-contiguous view takes the op's layout step.
    assert torch.equal(matmul(x.t().contiguous().t(), y), matmul_ref(x, y))
    with pytest.raises(ValueError, match="contraction"):
        matmul(x, x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mm.matmul(x.to("meta"), y.to("meta"))
