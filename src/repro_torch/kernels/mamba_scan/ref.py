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
    Returns (y (BH, S, P) in xdt's dtype, final state (BH, P, N) f32), all
    in f32; for f64 xdt all in f64 (the state too): the gradient tests'
    oracle under autograd."""
    bh, s, p = xdt.shape
    n = b.shape[-1]
    ct = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    h = (torch.zeros((bh, p, n), dtype=ct, device=xdt.device)
         if h0 is None else h0.to(ct))
    ys = []
    for t in range(s):
        a_t = torch.exp(la[:, t].to(ct))[:, None, None]
        h = a_t * h + xdt[:, t].to(ct)[:, :, None] * b[:, t].to(ct)[:, None, :]
        ys.append(torch.einsum("bpn,bn->bp", h, c[:, t].to(ct)))
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


def suffix_sum(d: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sum over the last axis, taken in f64 and rounded to
    f32: the transpose of ``prefix_sum``."""
    return torch.flip(torch.cumsum(torch.flip(d.double(), [-1]), dim=-1),
                      [-1]).float()


def ssd_scan_bwd_plain(
    xdt: torch.Tensor,   # (BH, S, P)
    la: torch.Tensor,    # (BH, S)
    b: torch.Tensor,     # (BH / rep, S, N)
    c: torch.Tensor,     # (BH / rep, S, N)
    dy: torch.Tensor,    # (BH, S, P) — gradient of y
    dstate: torch.Tensor | None,   # (BH, P, N) — gradient of the final state
    *,
    chunk: int = 256,
    rep: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``ssd_scan_plain``: (dxdt in xdt's dtype, dla f32,
    db and dc per group in b's dtype).  Head row r reads row r // rep of b
    and c, so db and dc sum the ``rep`` heads of a group's row.

    Per chunk, in f32, with ``cum`` the chunk's prefix sum of la, ``W_ij =
    exp(cum_i - cum_j)`` for j <= i (0 above), ``G = C Bᵀ``, ``M = dY Xᵀ``,
    ``E = G ⊙ W ⊙ M``, ``h_in`` the state entering the chunk (recomputed
    from the start) and ``dh`` the gradient of the state leaving it
    (``dstate``, or 0, at the last chunk)::

        dx_j  = Σ_{i>=j} G_ij W_ij dy_i + e^{cum_L - cum_j} dh B_j
        dB_j  = Σ_{i>=j} W_ij M_ij C_i + e^{cum_L - cum_j} dhᵀ x_j
        dC_i  = Σ_{j<=i} W_ij M_ij B_j + e^{cum_i} h_inᵀ dy_i
        dcum_i = Σ_j E_ij - Σ_k E_ki + e^{cum_i} dy_i·(h_in C_i)
                 - e^{cum_L - cum_i} x_iᵀ dh B_i
        dcum_L += e^{cum_L} <dh, h_in> + Σ_j e^{cum_L - cum_j} x_jᵀ dh B_j
        dla   = the suffix sum of dcum over the chunk (``suffix_sum``)
        dh   <- e^{cum_L} dh + Σ_i e^{cum_i} dy_i ⊗ C_i

    The products are f32; dcum is summed in f64 from them and its suffix
    sum rounded once (the E and r terms cancel there).  A last chunk
    shorter than ``chunk`` is taken as it is, as in the forward."""
    bh, s, p = xdt.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    f32 = torch.float32
    bm_all = torch.repeat_interleave(b, rep, 0) if rep > 1 else b
    cm_all = torch.repeat_interleave(c, rep, 0) if rep > 1 else c
    starts = list(range(0, s, chunk))
    # The state entering each chunk, as the forward carries it.
    h = torch.zeros((bh, p, n), dtype=f32, device=xdt.device)
    h_in = []
    for c0 in starts:
        sl = slice(c0, min(c0 + chunk, s))
        h_in.append(h)
        cum = prefix_sum(la[:, sl].float())
        wlast = torch.exp(cum[:, -1:] - cum)[:, :, None]
        h = torch.exp(cum[:, -1])[:, None, None] * h \
            + (xdt[:, sl].float() * wlast).transpose(1, 2) @ bm_all[:, sl].float()
    dx = torch.empty((bh, s, p), dtype=f32, device=xdt.device)
    dla = torch.empty((bh, s), dtype=f32, device=xdt.device)
    db = torch.empty((bh, s, n), dtype=f32, device=xdt.device)
    dc = torch.empty((bh, s, n), dtype=f32, device=xdt.device)
    dh = torch.zeros((bh, p, n), dtype=f32, device=xdt.device) \
        if dstate is None else dstate.float()
    for c0, hz in zip(reversed(starts), reversed(h_in)):
        sl = slice(c0, min(c0 + chunk, s))
        x, dyc = xdt[:, sl].float(), dy[:, sl].float()
        bm, cm = bm_all[:, sl].float(), cm_all[:, sl].float()
        cum = prefix_sum(la[:, sl].float())
        mask = torch.ones((cum.shape[1],) * 2, dtype=torch.bool,
                          device=xdt.device).tril()
        w = torch.where(mask, torch.exp(torch.clamp_max(
            cum[:, :, None] - cum[:, None, :], 0.0)), 0.0)
        m = dyc @ x.transpose(1, 2)                         # M = dY Xᵀ
        s_mat = (cm @ bm.transpose(1, 2)) * w               # G ⊙ W
        q_mat = m * w                                       # W ⊙ M
        e_mat = s_mat * m                                   # G ⊙ W ⊙ M
        wl = torch.exp(cum[:, -1:] - cum)                   # (BH, c)
        ec = torch.exp(cum)
        el = torch.exp(cum[:, -1])
        v = bm @ dh.transpose(1, 2)                         # dh B_j
        u = dyc @ hz                                        # h_inᵀ dy_i
        r = wl * (x * v).sum(-1)                            # x_jᵀ dh B_j w_j
        dx[:, sl] = s_mat.transpose(1, 2) @ dyc + wl[:, :, None] * v
        db[:, sl] = q_mat.transpose(1, 2) @ cm + wl[:, :, None] * (x @ dh)
        dc[:, sl] = q_mat @ bm + ec[:, :, None] * u
        # dcum in f64 from the f32 terms: each E_ij enters row i's sum and
        # column j's with one value, and each r_j position j and L, so the
        # suffix sum cancels them exactly where they cancel (a chunk's first
        # positions), as it would in exact arithmetic.
        e64, r64 = e_mat.double(), r.double()
        dcum = e64.sum(-1) - e64.sum(-2) \
            + (ec * (cm * u).sum(-1)).double() - r64
        dcum[:, -1] += (el * (dh * hz).sum((-2, -1))).double() + r64.sum(-1)
        dla[:, sl] = suffix_sum(dcum)
        dh = el[:, None, None] * dh + (dyc * ec[:, :, None]).transpose(1, 2) @ cm
    if rep > 1:
        db = db.reshape(bh // rep, rep, s, n).sum(1)
        dc = dc.reshape(bh // rep, rep, s, n).sum(1)
    return dx.to(xdt.dtype), dla, db.to(b.dtype), dc.to(c.dtype)
