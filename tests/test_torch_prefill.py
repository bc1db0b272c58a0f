"""Port parity: the bucketed prefill op of ``repro_torch`` against the JAX
package's, on the same numpy inputs.

The JAX op runs its Pallas kernel in interpret mode (as ``test_disagg.py``
does) and its jnp oracle; the port runs on the CPU, where its kernel wrapper
takes the plain version.  Tolerances are the reference's f32 ones
(``tests/test_kernels.py``: rtol 5e-4 / atol 5e-5); the cache cast is
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.prefill.ops import length_bucket as jax_length_bucket
from repro.kernels.prefill.ops import prefill_attention as jax_prefill
from repro_torch.kernels.autotune import device_backend, shape_bucket
from repro_torch.kernels.prefill import prefill as pf
from repro_torch.kernels.prefill.ops import length_bucket, prefill_attention

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

RTOL, ATOL = 5e-4, 5e-5


def _qkv(seed, s, hq, hkv, d=16, b=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


def _port(q, k, v, **kw):
    return prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("s", [32, 48])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
def test_prefill_matches_jax(hq, hkv, s, use_pallas):
    """GQA (2,2)/(4,2), a power-of-two and a clamped non-power-of-two bucket
    (48), against the interpret-mode Pallas kernel and the jnp oracle."""
    q, k, v = _qkv(s * 10 + hq, s, hq, hkv)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kern, kk, kv = jax_prefill(jq, jk, jv, use_pallas=True, interpret=True,
                               block_q=16, block_k=16)
    oracle, _, _ = jax_prefill(jq, jk, jv, use_pallas=False)
    out, kc, vc = _port(q, k, v, use_pallas=use_pallas)
    assert out.shape == (1, s, hq, 16) and kc.shape == (1, s, hkv, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(kk))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(kv))


def test_prefill_cache_dtype_cast_is_bitwise():
    q, k, v = _qkv(3, 16, 2, 2)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jout, jkc, jvc = jax_prefill(jq, jk, jv, cache_dtype=jnp.bfloat16,
                                 use_pallas=True, interpret=True,
                                 block_q=16, block_k=16)
    out, kc, vc = _port(q, k, v, cache_dtype=torch.bfloat16, use_pallas=True)
    assert out.dtype == torch.float32
    assert kc.dtype == vc.dtype == torch.bfloat16
    np.testing.assert_array_equal(kc.float().numpy(),
                                  np.asarray(jkc, np.float32))
    np.testing.assert_array_equal(vc.float().numpy(),
                                  np.asarray(jvc, np.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_prefill_end_padding_is_exact(use_pallas):
    """Rows [0, L) of a right-padded bucket equal the unpadded prompt's, in
    the port and against the JAX op on the exact length."""
    s, L = 32, 20
    q, k, v = _qkv(11, s, 2, 2)
    padded, _, _ = _port(q, k, v, use_pallas=use_pallas)
    exact, _, _ = _port(q[:, :L], k[:, :L], v[:, :L], use_pallas=use_pallas)
    np.testing.assert_allclose(padded[:, :L].numpy(), exact.numpy(),
                               rtol=RTOL, atol=ATOL)
    jexact, _, _ = jax_prefill(*(jnp.asarray(a[:, :L]) for a in (q, k, v)),
                               use_pallas=False)
    np.testing.assert_allclose(padded[:, :L].numpy(), np.asarray(jexact),
                               rtol=RTOL, atol=ATOL)


def test_length_bucket_ladder_matches_jax():
    assert length_bucket(1, 128) == 16
    assert length_bucket(17, 128) == 32
    assert length_bucket(100, 128) == 128
    assert length_bucket(40, 48) == 48       # clamped: not a power of two
    for max_seq in (16, 48, 64, 100, 1024):
        for n in range(1, max_seq + 1):
            assert length_bucket(n, max_seq) == jax_length_bucket(n, max_seq)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        length_bucket(129, 128)


def test_cpu_takes_plain_version_and_counts_no_launch():
    before = dict(pf.LAUNCHES)
    q, k, v = _qkv(5, 16, 4, 2)
    pf.prefill_flash(*(torch.from_numpy(a[0].transpose(1, 0, 2).copy())
                       for a in (q, k, v)), group=2,
                     cache_dtype=torch.bfloat16)
    assert pf.LAUNCHES == before


def test_prefill_flash_rejects_other_devices_and_bad_shapes():
    meta = [torch.empty((4, 16, 16), device="meta"),
            torch.empty((2, 16, 16), device="meta")]
    with pytest.raises(ValueError, match="cuda or cpu"):
        pf.prefill_flash(meta[0], meta[1], meta[1], group=2)
    cpu = torch.zeros((4, 16, 16)), torch.zeros((2, 16, 16))
    with pytest.raises(ValueError, match="kv heads"):
        pf.prefill_flash(cpu[0], cpu[1], cpu[1], group=4)
    with pytest.raises(ValueError, match="Sq == Skv"):
        pf.prefill_flash(cpu[0], torch.zeros((2, 8, 16)),
                         torch.zeros((2, 8, 16)), group=2)


def test_autotune_keys_by_torch_device():
    assert device_backend("cpu") == "cpu"
    assert shape_bucket({"sq": 48, "skv": 48, "d": 16}) == "d16_skv64_sq64"
