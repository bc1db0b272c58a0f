"""Public SSD op: mamba2-layout handling, padding, chunked / kernel dispatch.

Port of ``repro/kernels/mamba_scan/ops.py``.  Three implementations, all
equivalent:
  - ``ssd_scan_ref`` (ref.py): naive sequential scan — gold oracle.
  - ``ssd_chunked`` (the reference's ``ssd_chunked_jnp``) and
    ``ssd_chunked_grouped``: the SSD chunked algorithm in plain torch,
    vectorized over chunks with a loop carrying the state across them (the
    reference's ``lax.scan``) — the model's plain path.
  - Kernel K5 (mamba_scan.py, CUDA): the hot path on the card.

On the kernel route B and C go to K5 per group, where the reference
repeats them per head first, and S is not padded to a multiple of the
chunk: K5 masks its last chunk instead.  The reference's ``unroll`` (a
``lax.scan`` option) has no counterpart: the port's loop over chunks runs
in Python.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..autotune import lookup
from .mamba_scan import ssd_scan as _ssd_kernel_call
from .ref import prefix_sum, ssd_scan_ref

__all__ = ["ssd", "ssd_chunked", "ssd_chunked_grouped", "ssd_scan_ref"]

_DEFAULT_CHUNK = 128


def ssd_chunked(
    xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
    chunk: int = 128, h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD over (BH, S, ·) rows: intra-chunk quadratic form plus the
    state carried across chunks, all in f32."""
    bh, s, p = xdt.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, pad))
        la = F.pad(la, (0, pad))       # la=0 => a=1, xdt=0: state preserved
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    f32 = torch.float32
    xdt_c = xdt.reshape(bh, nc, chunk, p).to(f32)
    la_c = la.reshape(bh, nc, chunk).to(f32)
    b_c = b.reshape(bh, nc, chunk, n).to(f32)
    c_c = c.reshape(bh, nc, chunk, n).to(f32)
    cum = prefix_sum(la_c)                                # (bh, nc, c)
    g = torch.einsum("bzin,bzjn->bzij", c_c, b_c)
    idx = torch.arange(chunk, device=xdt.device)
    mask = idx[:, None] >= idx[None, :]
    logw = cum[..., :, None] - cum[..., None, :]
    s_mat = torch.where(mask, g * torch.exp(torch.clamp_max(logw, 0.0)), 0.0)
    y_intra = torch.einsum("bzij,bzjp->bzip", s_mat, xdt_c)
    chunk_decay = torch.exp(cum[..., -1])                 # (bh, nc)
    wlast = torch.exp(cum[..., -1:] - cum)                # (bh, nc, c)
    h_contrib = torch.einsum("bzcp,bzc,bzcn->bzpn", xdt_c, wlast, b_c)
    h = torch.zeros((bh, p, n), dtype=f32, device=xdt.device) \
        if h0 is None else h0
    h_prevs = []                                          # state entering each chunk
    for z in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, z, None, None] * h + h_contrib[:, z]
    h_prevs = torch.stack(h_prevs, dim=1)
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bzcn,bzpn->bzcp", c_c, h_prevs)
    y = (y_intra + y_inter).reshape(bh, nc * chunk, p)[:, :s]
    return y.to(xdt.dtype), h


def ssd_chunked_grouped(
    xdt: torch.Tensor,   # (B, G, R, S, P)   R = heads per group
    la: torch.Tensor,    # (B, G, R, S)
    b: torch.Tensor,     # (B, G, S, N)      NOT head-repeated
    c: torch.Tensor,     # (B, G, S, N)
    *,
    chunk: int = 128,
    h0: torch.Tensor | None = None,   # (B, G, R, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-aware chunked SSD.

    The Gram matrix (C_i . B_j) is per *group*, not per head, and B/C are
    never head-repeated.  The big tensors stay in the input dtype (bf16 in
    production), rounded where the reference rounds them; only the decay
    chain (cumsum / exp) runs in f32.  The reference's einsums take bf16
    operands with an f32 result (``preferred_element_type``): here their
    operands are widened to f32 first, which is exact, and summed in f32.
    The prefix sum of la is ``ref.prefix_sum``'s (f64, rounded once)."""
    bsz, g, r, s, p = xdt.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, pad))
        la = F.pad(la, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    mm = xdt.dtype
    f32 = torch.float32
    xdt_c = xdt.reshape(bsz, g, r, nc, chunk, p)
    la_c = la.reshape(bsz, g, r, nc, chunk).to(f32)
    b_c = b.reshape(bsz, g, nc, chunk, n)
    c_c = c.reshape(bsz, g, nc, chunk, n)
    cum = prefix_sum(la_c)                                # (B,G,R,nc,c) f32
    gram = torch.einsum("bgzin,bgzjn->bgzij", c_c.to(f32),
                        b_c.to(f32)).to(mm)               # per-GROUP
    idx = torch.arange(chunk, device=xdt.device)
    mask = idx[:, None] >= idx[None, :]
    logw = cum[..., :, None] - cum[..., None, :]          # (B,G,R,nc,c,c)
    decay = torch.exp(torch.clamp_max(logw, 0.0)).to(mm)
    s_mat = torch.where(mask, gram[:, :, None] * decay,
                        torch.zeros((), dtype=mm, device=xdt.device))
    y_intra = torch.einsum("bgrzij,bgrzjp->bgrzip", s_mat.to(f32),
                           xdt_c.to(f32))
    chunk_decay = torch.exp(cum[..., -1])                 # (B,G,R,nc) f32
    wlast = torch.exp(cum[..., -1:] - cum).to(mm)         # (B,G,R,nc,c)
    h_contrib = torch.einsum(
        "bgrzcp,bgrzc,bgzcn->bgrzpn", xdt_c.to(f32), wlast.to(f32),
        b_c.to(f32))
    h = torch.zeros((bsz, g, r, p, n), dtype=f32, device=xdt.device) \
        if h0 is None else h0
    h_prevs = []
    for z in range(nc):
        h_prevs.append(h)
        h = chunk_decay[..., z, None, None] * h + h_contrib[:, :, :, z]
    h_prevs = torch.stack(h_prevs, dim=3)                 # (B,G,R,nc,P,N)
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bgzcn,bgrzpn->bgrzcp", c_c.to(f32), h_prevs.to(mm).to(f32))
    y = (y_intra + y_inter).reshape(bsz, g, r, nc * chunk, p)[:, :, :, :s]
    return y.to(mm), h


def ssd(
    x: torch.Tensor,       # (B, S, H, P)
    dt: torch.Tensor,      # (B, S, H)  (softplus already applied)
    a: torch.Tensor,       # (H,)       (negative)
    b: torch.Tensor,       # (B, S, G, N)
    c: torch.Tensor,       # (B, S, G, N)
    d: torch.Tensor | None = None,   # (H,) skip connection
    *,
    chunk: int | None = None,
    use_pallas: bool | None = None,
    h0: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD layer core.  Returns (y (B,S,H,P), state (B,H,P,N)).

    ``chunk=None`` takes the autotune registry's winner for this shape
    bucket (``kernels/autotune.py``), falling back to 128.  ``use_pallas``
    keeps the reference's name for the kernel route: None means the kernel
    for tensors on CUDA; True routes through ``mamba_scan.ssd_scan`` (which
    takes its plain version on the CPU); False is the grouped plain path
    on any device.  The kernel route starts from zero state."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if chunk is None:
        chunk = lookup("ssd", {"s": s, "p": p, "n": n}, x.device).get(
            "chunk", _DEFAULT_CHUNK)
    if h % g:
        raise ValueError(f"n_groups {g} must divide heads {h}")
    rep = h // g
    if use_pallas is None:
        use_pallas = x.device.type == "cuda"
    xdt = x * dt[..., None]
    la = dt * a[None, None, :]
    if use_pallas:
        if h0 is not None:
            raise NotImplementedError("kernel path starts from zero state")
        y, state = _ssd_kernel_call(
            xdt.transpose(1, 2).reshape(bsz * h, s, p),
            la.transpose(1, 2).reshape(bsz * h, s),
            b.transpose(1, 2).reshape(bsz * g, s, n),
            c.transpose(1, 2).reshape(bsz * g, s, n),
            chunk=min(chunk, s), rep=rep)
        y = y.reshape(bsz, h, s, p).transpose(1, 2)
        state = state.reshape(bsz, h, p, n)
    else:
        h0g = None if h0 is None else h0.reshape(bsz, g, rep, p, n)
        y, state = ssd_chunked_grouped(
            xdt.transpose(1, 2).reshape(bsz, g, rep, s, p),
            la.transpose(1, 2).reshape(bsz, g, rep, s),
            b.transpose(1, 2), c.transpose(1, 2), chunk=chunk, h0=h0g)
        y = y.reshape(bsz, h, s, p).transpose(1, 2)
        state = state.reshape(bsz, h, p, n)
    if d is not None:
        y = y + x * d[None, None, :, None].to(x.dtype)    # keep compute dtype
    return y, state
