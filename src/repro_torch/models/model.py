"""Model facade: init / prefill / decode for the dense token decoder.

Port of ``repro/models/model.py``.  Batch format (tokens mode):
``{"tokens": (B,S) int}``.  Decode: ``decode_step(params, cache, inputs,
pos)`` processes one token per slot against a fixed-capacity cache.

Params are a nested dict of tensors laid out exactly like the reference's
pytree (``models/bridge.py`` loads the reference's weights); ``init(seed)``
draws the port's own random weights with a ``torch.Generator`` on the
model's device (the two packages' random numbers differ from one seed).
Training, enc-dec and embeds-input models raise ``NotImplementedError``
naming the port slice that brings them.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .config import ModelConfig
from .layers import (
    apply_norm,
    embed_tokens,
    init_embedding,
    init_norm,
    lm_logits,
)
from .transformer import (
    _LATER,
    apply_stack,
    check_layer,
    init_stack,
    init_stack_cache,
)


class Model:
    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None):
        self.cfg = cfg.validate()
        if cfg.is_enc_dec or cfg.input_mode != "tokens":
            raise NotImplementedError(
                f"{cfg.name}: enc-dec and embeds-input models come with the "
                "port's remaining-configs slice (MoE, MLA, enc-dec)"
            )
        for spec in cfg.prefix_pattern + cfg.layer_pattern:
            check_layer(spec)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        cfg = self.cfg
        return {
            "embed": init_embedding(gen, cfg),
            "final_norm": init_norm(cfg, self.device),
            "stack": init_stack(gen, cfg),
        }

    def loss(self, params, batch, capacities=None):
        raise NotImplementedError(_LATER["train"])

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch_size: int, seq: int) -> dict:
        return init_stack_cache(self.cfg, batch_size, seq, self.device)

    def prefill(self, params, batch, last_pos: int | None = None):
        """Full-prompt forward.  Returns (last-token logits (B,1,V), caches).

        ``last_pos`` selects which position's logits to return (default: the
        final one).  Bucketed prefill pads prompts to a fixed length on the
        right; causality keeps every valid position's activations exact, so
        the true last-token logits live at ``last_pos = L - 1``, not -1."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[
            None].expand(tokens.shape)
        x, caches = apply_stack(params["stack"], cfg, x, mode="prefill",
                                positions=positions)
        if last_pos is None:
            x = x[:, -1:]
        else:
            x = x[:, int(last_pos):int(last_pos) + 1]
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(params["embed"], x, cfg), caches

    def decode_step(self, params, caches, inputs, pos):
        """One-token decode.  ``inputs``: (B,1) tokens (or ``{"tokens":
        ...}``); ``pos``: scalar or per-slot (B,) positions.  Returns
        (logits (B,1,V), caches) — the caches are updated in place.  With
        ``cfg.decode_sample`` the first element is the argmax tokens."""
        cfg = self.cfg
        tok = inputs["tokens"] if isinstance(inputs, dict) else inputs
        x = embed_tokens(params["embed"], tok, cfg)
        x, caches = apply_stack(params["stack"], cfg, x, mode="decode",
                                caches=caches, pos=torch.as_tensor(
                                    pos, device=tok.device))
        x = apply_norm(cfg, params["final_norm"], x)
        logits = lm_logits(params["embed"], x, cfg)
        if cfg.decode_sample:
            return torch.argmax(logits, dim=-1).to(torch.int32), caches
        return logits, caches
