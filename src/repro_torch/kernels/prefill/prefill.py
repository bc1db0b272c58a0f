"""Bucketed prefill kernels: causal flash attention + fused cache cast.

Port of ``repro/kernels/prefill/prefill.py``.  The two Pallas programs
become two hand-written CUDA kernels in ``csrc/prefill.cu`` (see the note
at its top for what bounds them on the card and how the design answers):

  1. ``prefill_flash`` — the online-softmax causal flash recurrence,
     GQA-native (q-head row // group picks the K/V row, no repeat),
  2. ``cache_cast`` — the KV-handoff tensors written in the *cache* dtype,
     launched only when that differs from the input dtype.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain version (``ref.py``) — the port's counterpart of interpret mode.
There is no fallback from a failed launch.  ``LAUNCHES`` counts kernel
launches (and nothing else), so a run can show its path went through them.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ..build import build_library
from .ref import cache_cast_ref, prefill_ref

__all__ = ["prefill_flash", "cache_cast", "LAUNCHES", "SOURCES", "load_library"]

SOURCES = [os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "csrc", "prefill.cu")]

#: Kernel launches by kernel name, since the last ``LAUNCHES.clear()``.
LAUNCHES: dict[str, int] = {"prefill_flash": 0, "cache_cast": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (16, 32, 64, 128)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the prefill kernel library."""
    lib = ctypes.CDLL(build_library("prefill", SOURCES))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.prefill_flash.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                  ctypes.c_float, i32, vp]
    lib.prefill_flash.restype = i32
    lib.prefill_cache_cast.argtypes = [vp, vp, vp, vp, ctypes.c_int64, i32,
                                       i32, vp]
    lib.prefill_cache_cast.restype = i32
    lib.prefill_error_string.argtypes = [i32]
    lib.prefill_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.prefill_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _check_cuda(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported by the "
                        f"kernel (one of {sorted(map(str, _DTYPE_CODES))})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cache_cast(k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype):
    """K and V in ``dtype``: the cache-cast kernel on CUDA, ``.to`` on CPU."""
    if k.device.type == "cpu":
        return cache_cast_ref(k, v, dtype)
    if k.device.type != "cuda":
        raise ValueError(f"cache_cast runs on cuda or cpu, not {k.device}")
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError("cache_cast needs k and v of one shape and dtype")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"cache dtype {dtype} not supported by the kernel")
    _check_cuda("k", k, k.device)
    _check_cuda("v", v, k.device)
    kc = torch.empty(k.shape, dtype=dtype, device=k.device)
    vc = torch.empty(v.shape, dtype=dtype, device=v.device)
    lib = load_library()
    stream = torch.cuda.current_stream(k.device).cuda_stream
    err = lib.prefill_cache_cast(
        k.data_ptr(), v.data_ptr(), kc.data_ptr(), vc.data_ptr(), k.numel(),
        _DTYPE_CODES[k.dtype], _DTYPE_CODES[dtype], stream)
    _raise_on(lib, err, "cache_cast")
    LAUNCHES["cache_cast"] += 1
    return kc, vc


def prefill_flash(
    q: torch.Tensor,   # (B*Hq, S, D)
    k: torch.Tensor,   # (B*Hkv, S, D)   Hkv = Hq // group
    v: torch.Tensor,   # (B*Hkv, S, D)
    *,
    cache_dtype: torch.dtype | None = None,
    group: int = 1,
):
    """Fused bucketed prefill: returns (out, k_cache, v_cache).

    The kernel works in tiles of 64 query rows and 64 keys; S need not
    divide them — it masks the ragged edge.  ``cache_dtype`` (default: input
    dtype) is the storage dtype of the emitted handoff tensors."""
    bh, sq, d = q.shape
    bhkv, skv, _ = k.shape
    if bh != bhkv * group:
        raise ValueError(f"q heads {bh} != kv heads {bhkv} * group {group}")
    if sq != skv:
        raise ValueError(f"prefill needs Sq == Skv, got ({sq}, {skv})")
    cdt = cache_dtype if cache_dtype is not None else k.dtype
    if q.device.type == "cpu":
        return prefill_ref(q, k, v, cache_dtype=cdt, group=group)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_flash runs on cuda or cpu, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, q.device)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not compiled (one of {_HEAD_DIMS})")
    out = torch.empty_like(q)
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.prefill_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq, d,
        group, 1.0 / (d ** 0.5), _DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, err, "prefill_flash")
    LAUNCHES["prefill_flash"] += 1
    if cdt == k.dtype:
        return out, k, v
    kc, vc = cache_cast(k, v, cdt)
    return out, kc, vc
