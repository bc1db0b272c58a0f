"""Plain torch versions of the SSD scan.

Port of ``repro/kernels/mamba_scan/ref.py`` plus the plain version of
kernel K5:

  - ``ssd_scan_ref``: the naive sequential recurrence, the gold oracle;
  - ``ssd_scan_plain``: what the Pallas kernel ``_ssd_kernel`` /
    ``ssd_scan`` computes — per (B*H) row, chunk by chunk in f32, the
    (P, N) state carried from one chunk to the next.  It is what
    ``csrc/mamba_scan.cu`` is held against on the card and what
    ``mamba_scan.py`` runs for tensors on the CPU.  A last chunk shorter
    than ``chunk`` is taken as it is, which is what padding it with
    ``la = 0`` and ``xdt = 0`` (the reference's ``ops.py``) computes.

Every chunked route takes the prefix sum of la with ``prefix_sum``: in f64,
rounded to f32 once.  At full width the prefix sums reach the thousands
(la = dt A down to about -50 a step), where one f32 ulp is about 2.4e-4;
the decays are exp of their differences, so f32 prefix sums in two orders
(torch's CUDA scan, the kernel's loop) move a decay by that much relative,
and 64 layers carry it past the f32 tolerance.  In f64 the order no longer
shows: K5, the plain versions and the CPU and CUDA routes see one f32 cum.
(Torch's CPU cumsum of f32 accumulates in f64 too.)
"""

from __future__ import annotations

import torch


def prefix_sum(la: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis, taken in f64 and rounded to
    f32."""
    return torch.cumsum(la.double(), dim=-1).float()


def ssd_scan_ref(
    xdt: torch.Tensor,   # (BH, S, P)
    la: torch.Tensor,    # (BH, S)
    b: torch.Tensor,     # (BH, S, N)
    c: torch.Tensor,     # (BH, S, N)
    h0: torch.Tensor | None = None,   # (BH, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrence h_i = a_i h_{i-1} + xdt_i ⊗ B_i ; y_i = h_i·C_i.
    Returns (y (BH, S, P) in xdt's dtype, final state (BH, P, N) f32)."""
    bh, s, p = xdt.shape
    n = b.shape[-1]
    h = (torch.zeros((bh, p, n), dtype=torch.float32, device=xdt.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        a_t = torch.exp(la[:, t].float())[:, None, None]
        h = a_t * h + xdt[:, t].float()[:, :, None] * b[:, t].float()[:, None, :]
        ys.append(torch.einsum("bpn,bn->bp", h, c[:, t].float()))
    return torch.stack(ys, dim=1).to(xdt.dtype), h


def ssd_scan_plain(
    xdt: torch.Tensor,   # (BH, S, P) — dt-premultiplied input
    la: torch.Tensor,    # (BH, S)    — log decay dt*A (<= 0)
    b: torch.Tensor,     # (BH, S, N)
    c: torch.Tensor,     # (BH, S, N)
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's function: (y (BH, S, P) in xdt's dtype, final state (BH, P, N)
    f32), from zero state.  Per chunk, in f32: the masked decayed Gram
    ``(C Bᵀ) ⊙ exp(min(cumᵢ − cumⱼ, 0))`` times xdt, plus
    ``exp(cum) · C h₀ᵀ``; then ``h = exp(cum_last) h₀ + (xdt ⊙
    exp(cum_last − cum))ᵀ B``."""
    bh, s, p = xdt.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=xdt.device)
    y = torch.empty((bh, s, p), dtype=torch.float32, device=xdt.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        x, lc = xdt[:, sl].float(), la[:, sl].float()
        bm, cm = b[:, sl].float(), c[:, sl].float()
        cum = prefix_sum(lc)                                  # inclusive
        g = cm @ bm.transpose(1, 2)                           # (BH, c, c)
        mask = torch.ones(g.shape[1:], dtype=torch.bool,
                          device=g.device).tril()
        logw = cum[:, :, None] - cum[:, None, :]
        s_mat = torch.where(mask, g * torch.exp(torch.clamp_max(logw, 0.0)),
                            0.0)
        y_inter = torch.exp(cum)[:, :, None] * (cm @ h.transpose(1, 2))
        y[:, sl] = s_mat @ x + y_inter
        wlast = torch.exp(cum[:, -1:] - cum)[:, :, None]      # (BH, c, 1)
        h = torch.exp(cum[:, -1])[:, None, None] * h \
            + (x * wlast).transpose(1, 2) @ bm
    return y.to(xdt.dtype), h
