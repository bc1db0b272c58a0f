"""Model facade: init / loss / prefill / decode for token decoders whose
layers are attention or mamba mixers (dense MLPs, MoE or none).

Port of ``repro/models/model.py``.  Batch format (tokens mode):
``{"tokens": (B,S) int, "targets": (B,S) int, "loss_mask": (B,S) f32}``
(``loss`` reads all three; ``prefill`` only the tokens).  ``loss_mask``
carries the homogenization grain weights: the loss is the weighted token
mean (sum w·ce / sum w).  Decode: ``decode_step(params, cache, inputs,
pos)`` processes one token per slot against a fixed-capacity cache (a KV
cache per attention layer; a conv window and SSM state per mamba layer,
which ignore ``pos``).  ``capacities`` are the MoE layers' per-expert
capacities (``models/moe.py::capacity_per_expert``), for the loss and the
prefill; the decode's dropless MoE takes none.

Params are a nested dict of tensors laid out exactly like the reference's
pytree (``models/bridge.py`` loads the reference's weights); ``init(seed)``
draws the port's own random weights with a ``torch.Generator`` on the
model's device (the two packages' random numbers differ from one seed).
Enc-dec and embeds-input models raise ``NotImplementedError`` naming the
port slice that brings them.
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
from .transformer import apply_stack, check_layer, init_stack, init_stack_cache


def take_targets(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(logits, targets[..., None], -1)[..., 0]`` for
    (B, S, V) logits.  Advanced indexing, whose backward on CUDA sums in a
    fixed order (``torch.gather``'s scatter-add backward does not)."""
    b, s = targets.shape
    rows = torch.arange(b * s, device=logits.device)
    return logits.reshape(b * s, -1)[rows, targets.reshape(-1).long()] \
        .reshape(b, s)


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

    # ----------------------------------------------------------------- train
    def _embed(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, self.cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[
            None].expand(tokens.shape)
        return x, positions

    def hidden(self, params, batch, capacities=None):
        """Final normed hidden states (pre-LM-head) + aux loss (the MoE
        layers' load-balancing terms; 0 without MoE)."""
        cfg = self.cfg
        x, positions = self._embed(params, batch)
        x, _, aux = apply_stack(params["stack"], cfg, x, mode="train",
                                positions=positions, causal=True,
                                capacities=capacities)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
        return apply_norm(cfg, params["final_norm"], x), aux

    def logits(self, params, batch, capacities=None):
        x, aux = self.hidden(params, batch, capacities)
        return lm_logits(params["embed"], x, self.cfg), aux

    def _chunked_ce(self, params, x, targets, w) -> torch.Tensor:
        """Fused chunked cross-entropy: never materializes (B, S, V) —
        sequence chunks of the hidden states hit the LM head one at a time
        and reduce immediately to (logsumexp, target-logit) pairs."""
        cfg = self.cfg
        c = cfg.ce_chunk
        s = x.shape[1]
        pad = (-s) % c
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            targets = torch.nn.functional.pad(targets, (0, pad))
            w = torch.nn.functional.pad(w, (0, pad))
        table = (params["embed"]["head"] if "head" in params["embed"]
                 else params["embed"]["table"].T)
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

    def loss(self, params, batch, capacities=None):
        """(loss, metrics): the loss_mask-weighted token mean of the
        cross-entropy (plus the aux term), as the reference computes it."""
        w = batch["loss_mask"].float()
        wsum = torch.clamp(torch.sum(w), min=1.0)
        if self.cfg.ce_chunk > 0:
            x, aux = self.hidden(params, batch, capacities)
            ce = self._chunked_ce(params, x, batch["targets"], w) / wsum
        else:
            logits, aux = self.logits(params, batch, capacities)
            lp = torch.log_softmax(logits.float(), dim=-1)
            nll = -take_targets(lp, batch["targets"])
            ce = torch.sum(nll * w) / wsum
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": wsum}

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch_size: int, seq: int) -> dict:
        return init_stack_cache(self.cfg, batch_size, seq, self.device)

    def prefill(self, params, batch, capacities=None,
                last_pos: int | None = None):
        """Full-prompt forward.  Returns (last-token logits (B,1,V), caches).

        ``last_pos`` selects which position's logits to return (default: the
        final one).  Bucketed prefill pads prompts to a fixed length on the
        right; causality keeps every valid position's activations exact, so
        the true last-token logits live at ``last_pos = L - 1``, not -1.  The
        MoE capacities count the pad tokens too, which rank after the real
        ones, as in the reference."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[
            None].expand(tokens.shape)
        x, caches, _ = apply_stack(params["stack"], cfg, x, mode="prefill",
                                   positions=positions, capacities=capacities)
        if last_pos is None:
            x = x[:, -1:]
        else:
            x = x[:, int(last_pos):int(last_pos) + 1]
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(params["embed"], x, cfg), caches

    def decode_step(self, params, caches, inputs, pos, capacities=None):
        """One-token decode.  ``inputs``: (B,1) tokens (or ``{"tokens":
        ...}``); ``pos``: scalar or per-slot (B,) positions.  Returns
        (logits (B,1,V), caches) — the caches are updated in place.  With
        ``cfg.decode_sample`` the first element is the argmax tokens.
        ``capacities`` is passed on as the reference passes it; the
        decode's MoE is dropless and takes none."""
        cfg = self.cfg
        tok = inputs["tokens"] if isinstance(inputs, dict) else inputs
        x = embed_tokens(params["embed"], tok, cfg)
        x, caches, _ = apply_stack(params["stack"], cfg, x, mode="decode",
                                   caches=caches, pos=torch.as_tensor(
                                       pos, device=tok.device),
                                   capacities=capacities)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = lm_logits(params["embed"], x, cfg)
        if cfg.decode_sample:
            return torch.argmax(logits, dim=-1).to(torch.int32), caches
        return logits, caches
