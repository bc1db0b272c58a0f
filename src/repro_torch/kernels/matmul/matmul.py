"""Tiled matmul kernel K3: the paper's workload on the card.

Port of ``repro/kernels/matmul/matmul.py``.  The Pallas program becomes a
hand-written CUDA kernel in ``csrc/matmul.cu`` (see the note at its top for
what bounds it on the card, how the design answers, and why its rows are
bitwise independent of how the product is sliced).  It has two compiled
tiles, chosen by M inside the launch: 8-column strips for M <= 16 (the
TDA's 2- and 3-row grains) and 64 x 64 tiles above; both run the same
multiply-add chain per output element.  It masks ragged edges itself, so
any shape runs without padding and no block sizes are passed.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain version (``ref.py``), the port's counterpart of interpret mode.
There is no fallback from a failed launch.  ``LAUNCHES`` counts kernel
launches (and nothing else), so a run can show its path went through them.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ..build import build_library
from .ref import matmul_ref

__all__ = ["matmul", "LAUNCHES", "SOURCES", "load_library"]

SOURCES = [os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "csrc", "matmul.cu")]

#: Kernel launches by kernel name, since the counts were last set to 0.
LAUNCHES: dict[str, int] = {"matmul": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the matmul kernel library."""
    lib = ctypes.CDLL(build_library("matmul", SOURCES))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.matmul_launch.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.matmul_launch.restype = i32
    lib.matmul_error_string.argtypes = [i32]
    lib.matmul_error_string.restype = ctypes.c_char_p
    return lib


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N) in x's dtype, f32 accumulation.

    On CUDA, x and y must be contiguous, of one dtype (f32 or bf16) and on
    one device; anything else raises."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    if x.device.type == "cpu":
        return matmul_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu, not {x.device}")
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODES or y.dtype != x.dtype:
        raise TypeError(f"K3 takes x and y of one dtype, f32 or bf16; got "
                        f"{x.dtype} and {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("K3 needs contiguous x and y")
    (m, k), n = x.shape, y.shape[1]
    if min(m, n, k) < 1 or max(m, n, k) > _INT_MAX:
        raise ValueError(f"K3 needs 1 <= M, N, K < 2**31, got ({m}, {k}) @ "
                         f"({k}, {n})")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.matmul_launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n,
                            k, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        msg = lib.matmul_error_string(err).decode()
        raise RuntimeError(f"matmul launch failed: CUDA error {err} ({msg})")
    LAUNCHES["matmul"] += 1
    return out
