"""Mamba-2 SSD chunked scan, kernel K5: the mamba layers' scan, and its
gradient.

Port of ``repro/kernels/mamba_scan/mamba_scan.py``.  The Pallas program
becomes hand-written CUDA kernels in ``csrc/mamba_scan.cu`` (see the notes
there for what bounds them on the card and how the designs answer): bf16
inputs take ``ssd_scan_mma_kernel``, its four products on the tensor cores
from the tile helpers K1 and K4 share
(``../flash_attention/csrc/mma_tiles.cuh``), with the f32 decayed scores,
``xdt`` times its decays and the carried state entering as hi + lo bf16
terms; f32 inputs take ``ssd_scan_f32_kernel``, f32 FMAs on the CUDA cores
fed 16 bytes at a time, each output one FMA chain in ascending order (f32
inputs off a 16-byte boundary are staged by plain loads).  It reads B and C
per group (``rep`` heads share a row), where the reference's
kernel route repeats them per head, and it masks a last chunk shorter than
``chunk``, where the reference's wrapper requires S to divide.

The backward is the gradient of the same function, which the reference's
kernel route lacks (its models train through the plain route): five
kernels a call, chunk-parallel as the Mamba-2 paper's chunked algorithm is
(``ssd_bwd_sums_*``: the chunks' prefix sums and state sums;
``ssd_bwd_pass_kernel``: the states entering and the gradients leaving each
chunk, a short chain over the chunks; ``ssd_bwd_local_*``: a block per
(head row, chunk, 64-row tile) for dxdt, dB, dC and dla's partials;
``ssd_bwd_dla_kernel``; ``ssd_bwd_reduce_kernel`` for dB and dC per group),
``*`` being ``mma_kernel`` in bf16, on the tensor cores with the f32
operands as hi + lo bf16 terms, and ``kernel`` in f32, f32 FMAs.
``_SSDScan`` is the autograd function around forward and backward.  The
backward recomputes the states entering the chunks, so the forward saves
only its inputs.

Dispatch: a CUDA tensor launches the kernels or raises; a CPU tensor runs
the same autograd function over the plain versions (``ref.ssd_scan_plain``
with B and C repeated per head, and ``ref.ssd_scan_bwd_plain``) — the
port's counterpart of interpret mode.  There is no fallback from a failed
launch.  ``LAUNCHES`` counts kernel launches (and nothing else), so a run
can show its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ..build import build_library
from .ref import ssd_scan_bwd_plain, ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_bwd", "LAUNCHES", "SOURCES", "HEADERS",
           "load_library", "MAX_N", "MAX_P_BWD"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "csrc", "mamba_scan.cu")]
#: The tile header K1 and K4 share: the bf16 kernel's tile helpers, and
#: the copy helpers both kernels stage with.
HEADERS = [os.path.join(os.path.dirname(_HERE), "flash_attention", "csrc",
                        "mma_tiles.cuh")]

#: Kernel launches by kernel name, since the counts were last set to 0.
LAUNCHES: dict[str, int] = {"ssd_scan": 0, "ssd_scan_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Widest state the kernel compiles (the state sum lives in registers).
MAX_N = 128
#: Widest head the backward compiles (a thread owns 4 of 64 P columns).
MAX_P_BWD = 64
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the SSD-scan kernel library."""
    lib = ctypes.CDLL(build_library("mamba_scan", SOURCES, HEADERS))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan.argtypes = [vp] * 6 + [i32] * 7 + [vp]
    lib.ssd_scan.restype = i32
    lib.ssd_scan_smem_bytes.argtypes = [i32, i32, i32]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_bwd.argtypes = [vp] * 11 + [i32] * 7 + [vp]
    lib.ssd_scan_bwd.restype = i32
    lib.ssd_scan_bwd_workspace_floats.argtypes = [i32] * 4
    lib.ssd_scan_bwd_workspace_floats.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.ssd_scan_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(xdt, la, b, c, rep: int) -> tuple[int, int, int, int]:
    """Validate the shapes; return (bh, s, p, n)."""
    if xdt.ndim != 3 or la.ndim != 2 or b.ndim != 3 or c.shape != b.shape:
        raise ValueError(f"ssd_scan takes xdt (BH, S, P), la (BH, S) and b, "
                         f"c (BH / rep, S, N); got {tuple(xdt.shape)}, "
                         f"{tuple(la.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bh, s, p = xdt.shape
    n = b.shape[-1]
    if tuple(la.shape) != (bh, s):
        raise ValueError(f"la {tuple(la.shape)} must be ({bh}, {s})")
    if rep < 1 or bh != b.shape[0] * rep or b.shape[1] != s:
        raise ValueError(f"b, c {tuple(b.shape)} must be ({bh} / rep {rep}, "
                         f"{s}, N)")
    if min(bh, s, p, n) < 1 or max(bh * s * p, b.shape[0] * s * n) > _INT_MAX:
        raise ValueError("ssd_scan needs non-empty inputs below 2**31 "
                         "elements")
    return bh, s, p, n


def _check_cuda(xdt, la, b, c, n: int) -> None:
    """What the kernels take of CUDA inputs."""
    for name, t in (("la", la), ("b", b), ("c", c)):
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{xdt.device}")
    if xdt.dtype not in _DTYPE_CODES or b.dtype != xdt.dtype or \
            c.dtype != xdt.dtype:
        raise TypeError(f"K5 takes xdt, b and c of one dtype, f32 or bf16; "
                        f"got {xdt.dtype}, {b.dtype}, {c.dtype}")
    if not la.is_floating_point():
        raise TypeError(f"la must be floating point, got {la.dtype}")
    if n > MAX_N:
        raise ValueError(f"state width N={n} above the compiled {MAX_N}")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _check_aligned(**tensors) -> None:
    """K5's bf16 kernels copy 16-byte pieces: each tensor must start on a
    16-byte boundary."""
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"K5's bf16 kernels copy 16-byte pieces; {name} "
                             f"does not start on a 16-byte boundary")


def _forward_cuda(xdt, la, b, c, chunk: int, rep: int):
    """K5's forward kernel on checked CUDA tensors: (y, final state)."""
    bh, s, p = xdt.shape
    n = b.shape[-1]
    xdt, b, c = xdt.contiguous(), b.contiguous(), c.contiguous()
    _check_aligned(xdt=xdt, b=b, c=c)
    lib = load_library()
    la = la.to(torch.float32).contiguous()
    y = torch.empty_like(xdt)
    state = torch.empty((bh, p, n), dtype=torch.float32, device=xdt.device)
    _raise_on(lib, lib.ssd_scan(
        xdt.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), state.data_ptr(), bh, s, p, n, chunk, rep,
        _DTYPE_CODES[xdt.dtype],
        torch.cuda.current_stream(xdt.device).cuda_stream), "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, state


def ssd_scan_bwd(
    xdt: torch.Tensor,   # (BH, S, P)
    la: torch.Tensor,    # (BH, S)
    b: torch.Tensor,     # (BH / rep, S, N)
    c: torch.Tensor,     # (BH / rep, S, N)
    dy: torch.Tensor,    # (BH, S, P)
    dstate: torch.Tensor | None,   # (BH, P, N)
    *,
    chunk: int = 256,
    rep: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's backward kernels on CUDA tensors: (dxdt in xdt's dtype, dla
    f32, db and dc per group in b's dtype), the gradient of ``ssd_scan``'s
    (y, state) against ``dy`` and ``dstate`` (None: zero).  P up to
    ``MAX_P_BWD``; S need not divide ``chunk``; bf16 inputs start on a
    16-byte boundary."""
    bh, s, p, n = _check(xdt, la, b, c, rep)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd's kernels run on cuda, not "
                         f"{xdt.device}; the plain version is "
                         f"ref.ssd_scan_bwd_plain")
    _check_cuda(xdt, la, b, c, n)
    if p > MAX_P_BWD:
        raise ValueError(f"head width P={p} above the backward's compiled "
                         f"{MAX_P_BWD}")
    if tuple(dy.shape) != (bh, s, p) or dy.device != xdt.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} must be "
                         f"({bh}, {s}, {p}) on {xdt.device}")
    if dstate is not None:
        if tuple(dstate.shape) != (bh, p, n) or dstate.device != xdt.device:
            raise ValueError(f"dstate {tuple(dstate.shape)} must be ({bh}, "
                             f"{p}, {n}) on {xdt.device}")
        dstate = dstate.to(torch.float32).contiguous()
    chunk = min(chunk, s)
    xdt, b, c = xdt.contiguous(), b.contiguous(), c.contiguous()
    dy = dy.to(xdt.dtype).contiguous()
    _check_aligned(xdt=xdt, b=b, c=c, dy=dy)
    la = la.to(torch.float32).contiguous()
    lib = load_library()
    floats = lib.ssd_scan_bwd_workspace_floats(bh, s, n, chunk)
    work = torch.empty(floats, dtype=torch.float32, device=xdt.device)
    dxdt = torch.empty_like(xdt)
    dla = torch.empty((bh, s), dtype=torch.float32, device=xdt.device)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    _raise_on(lib, lib.ssd_scan_bwd(
        xdt.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(),
        dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
        dxdt.data_ptr(), dla.data_ptr(), db.data_ptr(), dc.data_ptr(),
        work.data_ptr(), bh, s, p, n, chunk, rep, _DTYPE_CODES[xdt.dtype],
        torch.cuda.current_stream(xdt.device).cuda_stream), "ssd_scan_bwd")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dxdt, dla, db, dc


class _SSDScan(torch.autograd.Function):
    """K5's forward; its backward is the backward kernels (on the CPU: the
    plain versions of both)."""

    @staticmethod
    def forward(ctx, xdt, la, b, c, chunk: int, rep: int):
        if xdt.device.type == "cpu":
            bh, bc = b, c
            if rep > 1:
                bh = torch.repeat_interleave(b, rep, dim=0)
                bc = torch.repeat_interleave(c, rep, dim=0)
            y, state = ssd_scan_plain(xdt, la, bh, bc, chunk=chunk)
        else:
            y, state = _forward_cuda(xdt, la, b, c, chunk, rep)
        ctx.save_for_backward(xdt, la.to(torch.float32), b, c)
        ctx.chunk, ctx.rep, ctx.la_dtype = chunk, rep, la.dtype
        # Training discards the state: its gradient then arrives as None.
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        xdt, la, b, c = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xdt)
        bwd = ssd_scan_bwd_plain if xdt.device.type == "cpu" else ssd_scan_bwd
        dxdt, dla, db, dc = bwd(xdt, la, b, c, dy, dstate, chunk=ctx.chunk,
                                rep=ctx.rep)
        return dxdt, dla.to(ctx.la_dtype), db, dc, None, None


def ssd_scan(
    xdt: torch.Tensor,   # (BH, S, P) — dt-premultiplied input
    la: torch.Tensor,    # (BH, S)    — log decay dt*A (<= 0)
    b: torch.Tensor,     # (BH / rep, S, N)
    c: torch.Tensor,     # (BH / rep, S, N)
    *,
    chunk: int = 256,
    rep: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (BH, S, P) in xdt's dtype, final state (BH, P, N) f32),
    from zero state, differentiable in xdt, la, b and c.  Head row r reads
    row r // rep of b and c; ``rep=1`` is the reference's interface.  S
    need not divide ``chunk``."""
    bh, s, p, n = _check(xdt, la, b, c, rep)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    chunk = min(chunk, s)
    if xdt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {xdt.device}")
    if xdt.device.type == "cuda":
        _check_cuda(xdt, la, b, c, n)
        if p > MAX_P_BWD and torch.is_grad_enabled() and any(
                t.requires_grad for t in (xdt, la, b, c)):
            raise ValueError(f"head width P={p} above the backward's "
                             f"compiled {MAX_P_BWD}")
    return _SSDScan.apply(xdt, la, b, c, chunk, rep)
