"""Mamba-2 block (SSD form, arXiv:2405.21060) with prefill and decode paths.

Port of ``repro/models/mamba.py``.  Projections are kept separate
(wz/wx/wb/wc/wdt instead of one fused in_proj), with the reference's leaf
names, so bridged weights load as they are.  The full-sequence path runs
the SSD scan through ``kernels.mamba_scan.ops.ssd`` (kernel K5 on the
card); the causal depthwise conv and the one-token recurrent decode stay
plain torch, as the reference computes them outside any Pallas kernel.

``mamba_decode`` updates the cache in place and returns it (the reference
returns a new one; the values are the same), as the attention decode does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan.ops import ssd
from .config import ModelConfig
from .layers import dense_init, dtype_of, gated_rms_norm

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


def mamba_train(
    p: dict, cfg: ModelConfig, x: torch.Tensor
) -> tuple[torch.Tensor, MambaCache]:
    """Full-sequence SSD.  Returns output and final recurrent state (used by
    prefill; train ignores it).  The conv window and the state cover every
    position of ``x``, pad tokens of a bucketed prompt included, as in the
    reference."""
    s, d_in, heads, gn, conv_ch = _dims(cfg)
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
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps)
    out = y @ p["wo"]
    conv_tail = torch.cat(
        [torch.zeros((b, s.d_conv - 1, conv_ch), dtype=u.dtype,
                     device=u.device), u], dim=1)[:, -(s.d_conv - 1):, :]
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
    p: dict, cfg: ModelConfig, x: torch.Tensor, cache: MambaCache
) -> tuple[torch.Tensor, MambaCache]:
    """One-token recurrent step.  x: (B, 1, d).  Writes the new conv window
    and state into ``cache`` and returns it."""
    s, d_in, heads, gn, conv_ch = _dims(cfg)
    b = x.shape[0]
    xt = x[:, 0]
    z = xt @ p["wz"]
    u_t = torch.cat([xt @ p["wx"], xt @ p["wb"], xt @ p["wc"]], dim=-1)
    dt_raw = (xt @ p["wdt"]).float()
    dt = F.softplus(dt_raw + p["dt_bias"])                # (B, H)
    window = torch.cat([cache.conv, u_t[:, None, :]], dim=1)  # (B, dc, C)
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
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps)
    out = (y @ p["wo"])[:, None, :]
    cache.conv.copy_(window[:, 1:])
    cache.state.copy_(state)
    return out, cache
