"""Flash attention kernel K4 and its backward: the training path's attention.

Port of ``repro/kernels/flash_attention/flash_attention.py``.  The Pallas
program becomes a hand-written CUDA kernel in ``csrc/flash_attention.cu``
(see the note at its top for what bounds it on the card and how the design
answers), which also writes each query row's log-sum-exp.  The reference
has no backward kernel; here CUDA kernels compute dQ, and dK with dV, from
the saved log-sum-exp, without atomics, so a gradient is the same bits on
every run.  bf16 inputs take tensor-core kernels for the forward, dQ and
dK/dV, built from the tile code in ``csrc/mma_tiles.cuh`` that K1 shares.
f32 inputs take the f32 forward body in ``csrc/f32_tiles.cuh`` (f32 FMAs
on the CUDA cores), which K1's f32 and f16 route shares, and a backward
whose products run on the tensor cores as three TF32 products each, with
the scores recomputed by the forward's own f32 chain (``score_chain``, in
the same header).  In both dtypes dK/dV goes per
q head into f32 scratch that this wrapper allocates, then is summed over
the group in head order.
``flash_attention`` is a ``torch.autograd.Function`` whose forward and
backward are those kernels.

Dispatch: a CUDA tensor launches the kernels or raises; a CPU tensor takes
the plain version (``ref.flash_attention_ref``, differentiated by autograd)
— the port's counterpart of interpret mode.  There is no fallback from a
failed launch.  ``LAUNCHES`` counts kernel launches (and nothing else), so
a run can show its path went through them.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ..build import build_library
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkdv", "LAUNCHES",
           "SOURCES", "HEADERS", "load_library"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = [os.path.join(_CSRC, "flash_attention.cu")]
#: The bf16 tile code and the f32 forward body with the f32 score chain,
#: both shared with K1 (``kernels/prefill/csrc/prefill.cu``).
HEADERS = [os.path.join(_CSRC, "mma_tiles.cuh"),
           os.path.join(_CSRC, "f32_tiles.cuh")]

#: Kernel launches by kernel name, since the counts were last set to 0.
LAUNCHES: dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_dkdv": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the flash-attention kernel library."""
    lib = ctypes.CDLL(build_library("flash_attention", SOURCES, HEADERS))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32, i32, i32, i32, i32, f32, i32, i32, vp]
    lib.flash_attention_fwd.argtypes = [vp] * 6 + shape
    lib.flash_attention_bwd_dq.argtypes = [vp] * 8 + shape
    lib.flash_attention_bwd_dkdv.argtypes = [vp] * 9 + shape
    for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
               lib.flash_attention_bwd_dkdv):
        fn.restype = i32
    lib.flash_attention_smem_bytes.argtypes = [i32, i32, i32]
    lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, *args) -> None:
    lib = load_library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           group: int) -> tuple[int, int, int, int]:
    """Validate the kernel's inputs; return (bh, sq, skv, d)."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q (BH, Sq, D) and k, v "
                         f"(BHkv, Skv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    bhkv, skv, dk = k.shape
    if dk != d:
        raise ValueError(f"head dims differ: q {d}, k {dk}")
    if group < 1 or bh != bhkv * group:
        raise ValueError(f"q heads {bh} != kv heads {bhkv} * group {group}")
    if min(bh, sq, skv) < 1 or max(bh * sq, bhkv * skv) * d > _INT_MAX:
        raise ValueError(f"flash attention needs non-empty inputs below "
                         f"2**31 elements, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    return bh, sq, skv, d


def _check_cuda(tensors: dict[str, torch.Tensor], d: int,
                backward: bool = False) -> None:
    """Device, dtype, contiguity and head dim; 16-byte aligned starts for
    the kernels that copy rows 16 bytes at a time (bf16, and the f32
    backward)."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"K4's kernels take CUDA tensors, got {first.device}")
    for name, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{first.device}")
        if t.dtype != first.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"K4 takes tensors of one dtype, f32 or bf16; "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"K4 needs contiguous inputs; {name} is not")
        if (t.dtype == torch.bfloat16 or backward) and t.data_ptr() % 16:
            raise ValueError(f"K4's {t.dtype} kernels copy 16-byte rows; "
                             f"{name} does not start on a 16-byte boundary")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not compiled (one of {_HEAD_DIMS})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, group: int = 1):
    """K4 forward on CUDA tensors: returns (out (BH, Sq, D) in q's dtype,
    lse (BH, Sq) f32, out32): ``out32`` is the output in f32 before its
    rounding (``out`` itself for f32 inputs), the backward's input."""
    bh, sq, skv, d = _check(q, k, v, group)
    _check_cuda({"q": q, "k": k, "v": v}, d)
    out = torch.empty_like(q)
    out32 = out if q.dtype == torch.float32 else torch.empty(
        q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if out32 is out else out32.data_ptr(),
            lse.data_ptr(), bh, sq, skv, d, group, 1.0 / (d ** 0.5),
            int(causal), _DTYPE_CODES[q.dtype], _stream(q))
    return out, lse, out32


def _check_f32(name: str, t: torch.Tensor, shape, dev) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or \
            t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous f32 {tuple(shape)} "
                         f"tensor on {dev}")


def _check_bwd(q, k, v, lse, dout, group):
    bh, sq, skv, d = _check(q, k, v, group)
    _check_cuda({"q": q, "k": k, "v": v, "dout": dout}, d, backward=True)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must be q's shape")
    _check_f32("lse", lse, (bh, sq), q.device)
    return bh, sq, skv, d


def flash_attention_bwd_dq(q, k, v, out32, lse, dout, *, causal: bool = True,
                           group: int = 1):
    """The dQ kernel on CUDA tensors, from the forward's ``out32`` and
    ``lse``: returns (dq in q's dtype, drow f32 (BH, Sq)), where drow =
    rowsum(dO * O) is the dK/dV kernel's input."""
    bh, sq, skv, d = _check_bwd(q, k, v, lse, dout, group)
    _check_f32("out32", out32, q.shape, q.device)
    if out32.data_ptr() % 16:
        raise ValueError("K4's dQ kernels read out32 16 bytes at a time; it "
                         "does not start on a 16-byte boundary")
    dq = torch.empty_like(q)
    drow = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_bwd_dq", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out32.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            drow.data_ptr(), dq.data_ptr(), bh, sq, skv, d, group,
            1.0 / (d ** 0.5), int(causal), _DTYPE_CODES[q.dtype], _stream(q))
    return dq, drow


def flash_attention_bwd_dkdv(q, k, v, lse, dout, drow, *, causal: bool = True,
                             group: int = 1):
    """The dK/dV kernel on CUDA tensors, from the dQ kernel's ``drow``:
    returns (dk, dv) in k's dtype."""
    bh, sq, skv, d = _check_bwd(q, k, v, lse, dout, group)
    _check_f32("drow", drow, (bh, sq), q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # The per-q-head f32 partials of dK, then dV, summed over the group.
    part = torch.empty((2, bh, skv, d), dtype=torch.float32,
                       device=q.device) if group > 1 else None
    _launch("flash_attention_bwd_dkdv", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), drow.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), bh, sq, skv, d, group,
            1.0 / (d ** 0.5), int(causal), _DTYPE_CODES[q.dtype], _stream(q))
    return dk, dv


def flash_attention_bwd(q, k, v, out32, lse, dout, *, causal: bool = True,
                        group: int = 1):
    """K4's backward on CUDA tensors: the dQ kernel, then the dK/dV kernel
    on the same stream.  Returns (dq, dk, dv) in the inputs' dtype."""
    dq, drow = flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                      causal=causal, group=group)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, lse, dout, drow,
                                      causal=causal, group=group)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K4 forward; its backward is the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, group: int):
        out, lse, out32 = flash_attention_fwd(q, k, v, causal=causal,
                                              group=group)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.causal, ctx.group = causal, group
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        # The backward kernels copy 16-byte rows: a view that starts off a
        # 16-byte boundary is copied to one that does not.
        q, k, v, dout = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                         else t.clone(memory_format=torch.contiguous_format)
                         for t in (q, k, v, dout))
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out32, lse, dout, causal=ctx.causal, group=ctx.group)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,   # (B*Hq, Sq, D)
    k: torch.Tensor,   # (B*Hkv, Skv, D)   Hkv = Hq // group
    v: torch.Tensor,   # (B*Hkv, Skv, D)
    *,
    causal: bool = True,
    group: int = 1,
) -> torch.Tensor:
    """Differentiable flash attention, (B*Hq, Sq, D) in q's dtype.

    The kernels work in tiles of 64 query rows and 64 keys, except dK/dV:
    blocks of 64 keys over steps of 32 queries (bf16) or 64 (f32).  Sq and
    Skv need not divide them — the ragged edge is masked."""
    _check(q, k, v, group)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, group=group)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _FlashAttention.apply(q, k, v, causal, group)
