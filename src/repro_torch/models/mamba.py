"""Mamba-2 block (SSD form, arXiv:2405.21060) with prefill and decode paths.

Port of ``repro/models/mamba.py``.  Projections are kept separate
(wz/wx/wb/wc/wdt instead of one fused in_proj), with the reference's leaf
names, so bridged weights load as they are.  The full-sequence path runs
the SSD scan through ``kernels.mamba_scan.ops.ssd`` (kernel K5 on the
card); the causal depthwise conv and the one-token recurrent decode stay
plain torch, as the reference computes them outside any Pallas kernel.

``mamba_decode`` updates the cache in place and returns it (the reference
returns a new one; the values are the same), as the attention decode does.

Split heads (``group``, a ``models/parallel.py::Group`` of more than one
rank): ``wz``, ``wx`` and ``wdt`` hold this rank's heads' columns and
``wo`` their rows, as ``sharding/policy.py`` stores them; ``wb``/``wc``
come whole (one group of B and C, which every head reads: a config of more
groups raises), and the per-head
vectors, the norm and the conv's columns are cut to the rank's heads
(``_local``).  K5 runs on the local heads; the gated norm's mean square is
taken over every rank's channels (``Group.total``), and ``wo``'s product
is this rank's partial sum.  A decode reads the whole conv window (its
channels do not split by heads; the reference's specs store it whole over
``model``) and this rank's heads of the state; it writes the whole new
window (the new column's x channels gathered over the ranks) and its own
state.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan.ops import ssd
from .config import ModelConfig
from .layers import dense_init, dtype_of, gated_rms_norm
from .parallel import SOLO, Group

__all__ = ["MambaCache", "F32_LEAVES", "init_mamba", "mamba_train",
           "init_mamba_cache", "mamba_decode"]

#: Leaves ``init_mamba`` keeps in f32 whatever ``param_dtype`` is.
F32_LEAVES = ("dt_bias", "a_log", "d_skip")


@dataclasses.dataclass(frozen=True)
class MambaCache:
    conv: torch.Tensor    # (B, d_conv-1, conv_channels) rolling window
    state: torch.Tensor   # (B, H, P, N) ssm state, f32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    heads = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    conv_ch = d_in + 2 * gn        # conv runs over (x, B, C) streams
    return s, d_in, heads, gn, conv_ch


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    s, d_in, heads, gn, conv_ch = _dims(cfg)
    dt = dtype_of(cfg.param_dtype)
    dev = gen.device
    f32 = torch.float32
    return {
        "wz": dense_init(gen, (cfg.d_model, d_in), dt),
        "wx": dense_init(gen, (cfg.d_model, d_in), dt),
        "wb": dense_init(gen, (cfg.d_model, gn), dt),
        "wc": dense_init(gen, (cfg.d_model, gn), dt),
        "wdt": dense_init(gen, (cfg.d_model, heads), dt),
        "dt_bias": torch.zeros((heads,), dtype=f32, device=dev),
        # A = -exp(a_log), mamba2 init A in [1, 16]
        "a_log": torch.log(torch.linspace(1.0, 16.0, heads, dtype=f32,
                                          device=dev)),
        "d_skip": torch.ones((heads,), dtype=f32, device=dev),
        "conv_w": dense_init(gen, (s.d_conv, conv_ch), dt, scale=1.0),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "norm": torch.ones((d_in,), dtype=dt, device=dev),
        "wo": dense_init(gen, (d_in, cfg.d_model), dt),
    }


def _conv_full(p: dict, u: torch.Tensor, d_conv: int) -> torch.Tensor:
    """Causal depthwise conv over (B, S, C): pad left, window-sum."""
    pad = d_conv - 1
    up = F.pad(u, (0, 0, pad, 0))
    out = sum(
        up[:, i:i + u.shape[1], :] * p["conv_w"][i][None, None, :]
        for i in range(d_conv)
    )
    return F.silu((out + p["conv_b"]).float()).to(u.dtype)


def _local(p: dict, cfg: ModelConfig, group: Group):
    """This rank's share of a layer whose heads ``group`` splits, and the
    indices of its conv channels (its x channels, then every B and C
    channel) in the whole conv window; the params as they are, and None,
    for one rank.  One group of B and C only (every config's): each head
    reads it whole."""
    if group.size == 1:
        return p, None
    s, d_in, _, gn, _ = _dims(cfg)
    if s.n_groups != 1:
        raise ValueError(f"mamba: split heads need n_groups 1, not "
                         f"{s.n_groups}")
    h = p["wdt"].shape[1]
    x0, x1 = group.rank * h * s.head_dim, (group.rank + 1) * h * s.head_dim
    dev = p["wx"].device
    cols = torch.cat([torch.arange(x0, x1, device=dev),
                      torch.arange(d_in, d_in + 2 * gn, device=dev)])
    out = dict(p)
    for name in F32_LEAVES:
        out[name] = p[name][group.rank * h:(group.rank + 1) * h]
    out["norm"] = p["norm"][x0:x1]
    out["conv_w"] = p["conv_w"][:, cols]
    out["conv_b"] = p["conv_b"][cols]
    return out, cols


def _whole_channels(u: torch.Tensor, d_local: int,
                    group: Group) -> torch.Tensor:
    """Conv inputs (..., this rank's ``d_local`` x channels, then every B
    and C channel) as every conv channel: the x channels gathered over the
    ranks (no gradient)."""
    return torch.cat([group.gather(u[..., :d_local], -1), u[..., d_local:]],
                     dim=-1)


def mamba_train(
    p: dict, cfg: ModelConfig, x: torch.Tensor, *, group: Group = SOLO,
    cache: bool = True,
) -> tuple[torch.Tensor, MambaCache | None]:
    """Full-sequence SSD.  Returns output and final recurrent state (used by
    prefill; train asks for none: ``cache=False`` gives None).  The conv
    window and the state cover every position of ``x``, pad tokens of a
    bucketed prompt included, as in the reference.  Under split heads
    (``group``) the output is this rank's partial sum over its heads (its
    ``wo`` rows), the state its heads' and the conv window whole."""
    s, d_full = cfg.ssm, cfg.ssm.d_inner(cfg.d_model)
    p, cols = _local(p, cfg, group)
    d_in, heads, gn = p["wx"].shape[1], p["wdt"].shape[1], _dims(cfg)[3]
    b, seq, _ = x.shape
    z = x @ p["wz"]
    xs = x @ p["wx"]
    bs = x @ p["wb"]
    cs = x @ p["wc"]
    dt_raw = (x @ p["wdt"]).float()
    dt = F.softplus(dt_raw + p["dt_bias"])
    u = torch.cat([xs, bs, cs], dim=-1)
    conv_out = _conv_full(p, u, s.d_conv)
    xc = conv_out[..., :d_in].reshape(b, seq, heads, s.head_dim)
    bc = conv_out[..., d_in:d_in + gn].reshape(b, seq, s.n_groups, s.d_state)
    cc = conv_out[..., d_in + gn:].reshape(b, seq, s.n_groups, s.d_state)
    a = -torch.exp(p["a_log"])
    y, state = ssd(xc, dt.to(xc.dtype), a, bc, cc, p["d_skip"],
                   chunk=s.chunk, use_pallas=cfg.use_pallas)
    y = y.reshape(b, seq, d_in)
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps, group, d_full)
    out = group.row_product(torch.matmul, y, p["wo"])
    if not cache:
        return out, None
    conv_tail = torch.cat(
        [torch.zeros((b, s.d_conv - 1, u.shape[-1]), dtype=u.dtype,
                     device=u.device), u], dim=1)[:, -(s.d_conv - 1):, :]
    if cols is not None:
        conv_tail = _whole_channels(conv_tail.detach(), d_in, group)
    return out, MambaCache(conv=conv_tail, state=state)


def init_mamba_cache(cfg: ModelConfig, batch: int, device) -> MambaCache:
    s, d_in, heads, gn, conv_ch = _dims(cfg)
    dt = dtype_of(cfg.compute_dtype)
    return MambaCache(
        conv=torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dt,
                         device=device),
        state=torch.zeros((batch, heads, s.head_dim, s.d_state),
                          dtype=torch.float32, device=device),
    )


def mamba_decode(
    p: dict, cfg: ModelConfig, x: torch.Tensor, cache: MambaCache, *,
    group: Group = SOLO,
) -> tuple[torch.Tensor, MambaCache]:
    """One-token recurrent step.  x: (B, 1, d).  Writes the new conv window
    and state into ``cache`` and returns it.  Under split heads
    (``group``) ``cache`` holds the whole conv window and this rank's
    heads of the state, and the output is this rank's partial sum."""
    s, d_full = cfg.ssm, cfg.ssm.d_inner(cfg.d_model)
    p, cols = _local(p, cfg, group)
    d_in, heads, gn = p["wx"].shape[1], p["wdt"].shape[1], _dims(cfg)[3]
    b = x.shape[0]
    xt = x[:, 0]
    z = xt @ p["wz"]
    u_t = torch.cat([xt @ p["wx"], xt @ p["wb"], xt @ p["wc"]], dim=-1)
    dt_raw = (xt @ p["wdt"]).float()
    dt = F.softplus(dt_raw + p["dt_bias"])                # (B, H)
    conv = cache.conv if cols is None else cache.conv[..., cols]
    window = torch.cat([conv, u_t[:, None, :]], dim=1)    # (B, dc, C)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xc = conv_out[:, :d_in].reshape(b, heads, s.head_dim)
    bc = conv_out[:, d_in:d_in + gn].reshape(b, s.n_groups, s.d_state)
    cc = conv_out[:, d_in + gn:].reshape(b, s.n_groups, s.d_state)
    rep = heads // s.n_groups
    bch = torch.repeat_interleave(bc, rep, dim=1)         # (B, H, N)
    cch = torch.repeat_interleave(cc, rep, dim=1)
    a = -torch.exp(p["a_log"])                            # (H,)
    decay = torch.exp(dt * a[None, :])                    # (B, H)
    xdt = xc.float() * dt[..., None]                      # (B, H, P)
    state = cache.state * decay[..., None, None] + \
        xdt[..., :, None] * bch.float()[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, cch.float())
    y = y + xc.float() * p["d_skip"][None, :, None]
    y = y.reshape(b, d_in).to(x.dtype)
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps, group, d_full)
    out = group.row_product(torch.matmul, y, p["wo"])[:, None, :]
    if cols is None:
        cache.conv.copy_(window[:, 1:])
    else:
        cache.conv.copy_(torch.cat([cache.conv[:, 1:], _whole_channels(
            u_t[:, None, :], d_in, group)], dim=1))
    cache.state.copy_(state)
    return out, cache
