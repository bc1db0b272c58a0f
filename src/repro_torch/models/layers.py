"""Shared neural building blocks (plain torch; dtype-disciplined).

Port of ``repro/models/layers.py``.  Conventions kept from the reference:

  - params are plain nested dicts of tensors, with the reference's leaf
    names, so bridged weights load as they are,
  - compute happens in ``cfg.compute_dtype``; norms/softmax accumulate f32,
  - every initializer takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
from torch._guards import detect_fake_mode

from .config import ModelConfig

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_of(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


# ------------------------------------------------------------------ initializers
def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = (scale if scale is not None else 1.0) / max(fan_in, 1) ** 0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * 0.02).to(dtype)


# ------------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def init_norm(cfg: ModelConfig, device, dim: int | None = None) -> dict:
    d = dim or cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p = {"scale": torch.ones((d,), dtype=dt, device=device)}
    if cfg.use_layernorm:
        p["bias"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.use_layernorm:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def gated_rms_norm(x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                   eps: float, group=None, width: int = 0) -> torch.Tensor:
    """Mamba-2 output norm: RMSNorm(x * silu(z)).  ``group``
    (``models/parallel.py``) of more than one rank: ``x``, ``gate`` and
    ``weight`` are this rank's channels of ``width``, and the mean square
    is taken over all of them (the sum of squares summed over the
    ranks)."""
    g = torch.nn.functional.silu(gate.float()).to(x.dtype)
    if group is None or group.size == 1:
        return rms_norm(x * g, weight, eps)
    xf = (x * g).float()
    var = group.total(torch.sum(xf * xf, dim=-1, keepdim=True)) / width
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


# ------------------------------------------------------------------------- RoPE
#: ``rope_freqs`` on CUDA by (head_dim, theta, device): built once, outside
#: the engine's captured steps, whose replays then launch nothing for them.
_FREQS: dict[tuple, torch.Tensor] = {}


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """1 / theta^(2i / head_dim), (head_dim / 2,) f32.  ``theta`` enters by
    ``torch.full`` on ``device``, a fill, where ``torch.tensor(theta)``
    would copy from host memory (forbidden while a CUDA graph is captured),
    with the same bits.  On CUDA (real tensors) they are computed once per
    (head_dim, theta, device) and kept; elsewhere anew on every call, so a
    CPU step holds no tensor the dry run's step on fake tensors does
    not."""
    device = torch.device(device)
    key = (head_dim, float(theta), device)
    freqs = _FREQS.get(key)
    if freqs is None:
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
        base = torch.full((), theta, dtype=torch.float32, device=device)
        freqs = 1.0 / torch.pow(base, exps)
        if device.type == "cuda" and detect_fake_mode() is None:
            _FREQS[key] = freqs
    return freqs


def apply_rope(
    x: torch.Tensor,           # (B, S, H, D)
    positions: torch.Tensor,   # (B, S) int, or (B, 3, S) for M-RoPE
    theta: float,
    mrope_sections: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    if mrope_sections is None:
        if positions.ndim == 3:
            positions = positions[:, 0]
        angles = positions[..., None].float() * freqs         # (B,S,D/2)
    else:
        # M-RoPE (Qwen2-VL): the frequency pairs split across the (t, h, w)
        # position streams: the first ``sections[0]`` pairs take the
        # temporal id, and so on.  A (B, S) input is three equal streams.
        if positions.ndim == 2:
            positions = positions[:, None, :].expand(
                positions.shape[0], 3, positions.shape[1])
        sec = mrope_sections
        assert sum(sec) == d // 2, (sec, d)
        comp = torch.cat([torch.full((s,), i, dtype=torch.long,
                                     device=x.device)
                          for i, s in enumerate(sec)])        # (D/2,) stream
        pos_sel = positions.float()[:, comp, :]               # (B,D/2,S)
        angles = pos_sel.transpose(1, 2) * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]                    # (B,S,1,D/2)
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat(
        [xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1
    ).to(x.dtype)


# ----------------------------------------------------------------------- MLP(s)
def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None) -> dict:
    dt = dtype_of(cfg.param_dtype)
    ff = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (cfg.d_model, ff), dt),
        "w_up": dense_init(gen, (cfg.d_model, ff), dt),
        "w_down": dense_init(gen, (ff, cfg.d_model), dt),
    }


def apply_mlp(p: dict, x: torch.Tensor, group=None) -> torch.Tensor:
    """SwiGLU (all assigned LM archs use gated SiLU MLPs).  ``group``
    (``models/parallel.py``) forms ``w_down``'s row-parallel product where
    the width is split."""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    if group is None:
        return h @ p["w_down"]
    return group.row_product(torch.matmul, h, p["w_down"])


# ------------------------------------------------------------------- embeddings
def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg.param_dtype)
    p = {"table": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dt)
    return p


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["table"][tokens]


def lm_logits(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = p["head"] if "head" in p else p["table"].T
    logits = (x @ table).to(dtype_of(cfg.logit_dtype))
    if cfg.padded_vocab != cfg.vocab_size:
        # Padded vocab rows never win an argmax: the reference's -1e30 mask.
        # ``fill_`` takes the scalar as an argument; an item assignment
        # would make it a host tensor first, which a CUDA graph cannot copy.
        mask = torch.zeros((cfg.padded_vocab,), dtype=logits.dtype,
                           device=logits.device)
        mask[cfg.vocab_size:].fill_(-1e30)
        logits = logits + mask
    return logits


def take_targets(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(logits, targets[..., None], -1)[..., 0]`` for
    (B, S, V) logits.  Advanced indexing, whose backward on CUDA sums in a
    fixed order (``torch.gather``'s scatter-add backward does not)."""
    b, s = targets.shape
    rows = torch.arange(b * s, device=logits.device)
    return logits.reshape(b * s, -1)[rows, targets.reshape(-1).long()] \
        .reshape(b, s)


def chunked_ce(p: dict, x: torch.Tensor, targets: torch.Tensor,
               w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Fused chunked cross-entropy: never materializes (B, S, V) —
    sequence chunks of the hidden states hit the LM head one at a time and
    reduce immediately to (logsumexp, target-logit) pairs.  Returns the
    weighted sum."""
    c = cfg.ce_chunk
    s = x.shape[1]
    pad = (-s) % c
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    table = p["head"] if "head" in p else p["table"].T
    pad_vocab = None
    if cfg.padded_vocab != cfg.vocab_size:
        pad_vocab = torch.arange(cfg.padded_vocab,
                                 device=x.device) >= cfg.vocab_size
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s + pad, c):
        lg = (x[:, i:i + c] @ table).float()
        if pad_vocab is not None:
            lg = lg.masked_fill(pad_vocab, -1e30)
        lse = torch.logsumexp(lg, dim=-1)
        tlog = take_targets(lg, targets[:, i:i + c])
        total = total + torch.sum((lse - tlog) * w[:, i:i + c])
    return total
