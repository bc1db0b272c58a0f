"""Model facade: init / loss / prefill / decode / encode for every
architecture family of the reference.

Port of ``repro/models/model.py``.  Batch formats:
  tokens mode : {"tokens": (B,S) int, "targets": (B,S) int, "loss_mask": (B,S) f32}
  embeds mode : {"embeds": (B,S,d), "positions": (B,S)|(B,3,S) int, "targets", "loss_mask"}
  enc-dec     : {"src_embeds": (B,Ss,d), "tgt_tokens": (B,St) int, "targets", "loss_mask"}
(``loss`` reads all of them; ``prefill`` only the inputs).  ``loss_mask``
carries the homogenization grain weights: the loss is the weighted token
mean (sum w·ce / sum w).  An enc-dec model runs its encoder
(``encode``: ``ENC_PATTERN`` layers, non-causal) on the source embeddings,
and its decoder layers (``dec_pattern``) cross-attend to that memory.

Decode: ``decode_step(params, cache, inputs, pos)`` processes one token per
slot against a fixed-capacity cache (a KV cache per attention layer, a
latent cache per MLA layer, a conv window and SSM state per mamba layer,
which ignore ``pos``; enc-dec decoder layers add the encoder memory's K/V,
from ``init_cache(..., cross_seq=)`` filled by the prefill's).  As in the
reference, the self-attention decode ropes with ``pos``: the ``(B, 3, 1)``
positions of an embeds-mode decode input are not read.  ``capacities`` are
the MoE layers' per-expert capacities (``models/moe.py::
capacity_per_expert``), for the loss and the prefill; the decode's dropless
MoE takes none.

Params are a nested dict of tensors laid out exactly like the reference's
pytree (``models/bridge.py`` loads the reference's weights); ``init(seed)``
draws the port's own random weights with a ``torch.Generator`` on the
model's device (the two packages' random numbers differ from one seed);
``abstract_params`` gives the same tree on the meta device.

Every entry point takes ``par``, the one object between the model and
sharding (``models/parallel.py``): ``SINGLE`` by default, the identity on
every hook.  A sharded step (``sharding/apply.py``) passes its own: the
batch is then this rank's rows of the global batch, and ``loss`` returns
this rank's terms over its own weight sum (the step divides by the global
one).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..tree import tree_map
from .config import LayerSpec, ModelConfig
from .layers import apply_norm, dtype_of, init_embedding, init_norm
from .parallel import SINGLE, Parallel
from .transformer import apply_stack, init_stack, init_stack_cache

ENC_PATTERN = (LayerSpec(mixer="attn", mlp="dense"),)


def dec_pattern(cfg: ModelConfig) -> tuple[LayerSpec, ...]:
    if not cfg.is_enc_dec:
        return cfg.layer_pattern
    return tuple(LayerSpec(mixer=s.mixer, mlp=s.mlp, cross_attn=True)
                 for s in cfg.layer_pattern)


def _arange_positions(x: torch.Tensor) -> torch.Tensor:
    """0 .. S-1 for each row of a (B, S, ...) input."""
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device)[None].expand(b, s)


class Model:
    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None):
        self.cfg = cfg.validate()
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        cfg = self.cfg
        params = {
            "embed": init_embedding(gen, cfg),
            "final_norm": init_norm(cfg, self.device),
            "stack": init_stack(gen, cfg, pattern=dec_pattern(cfg)),
        }
        if cfg.is_enc_dec:
            params["enc_stack"] = init_stack(
                gen, cfg, pattern=ENC_PATTERN, prefix=(),
                n_periods=cfg.encoder.n_layers)
            params["enc_final_norm"] = init_norm(cfg, self.device)
        return params

    def abstract_params(self, seed: int = 0) -> dict:
        """The tree ``init`` gives (paths, shapes, dtypes) on the meta
        device, with nothing allocated: ``init`` runs on fake tensors."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            fake = Model(self.cfg, device="cpu").init(seed)
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), fake)

    # ----------------------------------------------------------------- embed
    def _embed(self, params, batch, par: Parallel
               ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if cfg.is_enc_dec:
            x = par.embed_tokens(params["embed"], batch["tgt_tokens"], cfg)
            return x, _arange_positions(x)
        if cfg.input_mode == "embeds":
            return (batch["embeds"].to(dtype_of(cfg.compute_dtype)),
                    batch["positions"])
        x = par.embed_tokens(params["embed"], batch["tokens"], cfg)
        return x, _arange_positions(x)

    def encode(self, params, src_embeds: torch.Tensor,
               par: Parallel = SINGLE) -> torch.Tensor:
        """The encoder memory (B, Ss, d): non-causal ``ENC_PATTERN`` layers
        over the source embeddings, then the encoder's final norm."""
        cfg = self.cfg
        x = src_embeds.to(dtype_of(cfg.compute_dtype))
        x, _, _ = apply_stack(params["enc_stack"], cfg, x, mode="train",
                              positions=_arange_positions(x), causal=False,
                              pattern=ENC_PATTERN, prefix=(), par=par)
        return apply_norm(cfg, params["enc_final_norm"], x)

    def _stack(self, params, batch, mode: str, capacities, par: Parallel):
        """The decoder stack over the batch's inputs (with the encoder
        memory of an enc-dec model): (x, caches, aux)."""
        cfg = self.cfg
        x, positions = self._embed(params, batch, par)
        memory = mem_pos = None
        if cfg.is_enc_dec:
            memory = self.encode(params, batch["src_embeds"], par)
            mem_pos = _arange_positions(memory)
        return apply_stack(params["stack"], cfg, x, mode=mode,
                           positions=positions, causal=True,
                           cross_memory=memory, mem_positions=mem_pos,
                           capacities=capacities, pattern=dec_pattern(cfg),
                           par=par)

    # ----------------------------------------------------------------- train
    def hidden(self, params, batch, capacities=None, par: Parallel = SINGLE):
        """Final normed hidden states (pre-LM-head) + aux loss (the MoE
        layers' load-balancing terms; 0 without MoE)."""
        x, _, aux = self._stack(params, batch, "train", capacities, par)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
        return apply_norm(self.cfg, params["final_norm"], x), aux

    def logits(self, params, batch, capacities=None, par: Parallel = SINGLE):
        x, aux = self.hidden(params, batch, capacities, par)
        return par.lm_logits(params["embed"], x, self.cfg), aux

    def loss(self, params, batch, capacities=None, par: Parallel = SINGLE):
        """(loss, metrics): the loss_mask-weighted token mean of the
        cross-entropy (plus the aux term), as the reference computes it.
        ``tokens`` is the weight sum it divides by: a sharded step's own
        rows' (``sharding/apply.py`` rescales to the global batch's)."""
        w = batch["loss_mask"].float()
        wsum = torch.clamp(torch.sum(w), min=1.0)
        x, aux = self.hidden(params, batch, capacities, par)
        if self.cfg.ce_chunk > 0:
            ce = par.chunked_ce(params["embed"], x, batch["targets"], w,
                                self.cfg) / wsum
        else:
            nll = par.token_nll(params["embed"], x, batch["targets"],
                                self.cfg)
            ce = torch.sum(nll * w) / wsum
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": wsum}

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch_size: int, seq: int,
                   cross_seq: int | None = None) -> dict:
        """Zeroed decode caches; ``cross_seq`` sizes an enc-dec model's
        cross caches (``seq`` by default)."""
        return init_stack_cache(self.cfg, batch_size, seq, self.device,
                                pattern=dec_pattern(self.cfg),
                                cross_seq=cross_seq)

    def prefill(self, params, batch, capacities=None,
                last_pos: int | None = None, par: Parallel = SINGLE):
        """Full-prompt forward.  Returns (last-token logits (B,1,V), caches).

        ``last_pos`` selects which position's logits to return (default: the
        final one).  Bucketed prefill pads prompts to a fixed length on the
        right; causality keeps every valid position's activations exact, so
        the true last-token logits live at ``last_pos = L - 1``, not -1.  The
        MoE capacities count the pad tokens too, which rank after the real
        ones, as in the reference.  An enc-dec model encodes
        ``batch["src_embeds"]`` first and returns each decoder layer's
        cross K/V in its caches."""
        cfg = self.cfg
        x, caches, _ = self._stack(params, batch, "prefill", capacities, par)
        if last_pos is None:
            x = x[:, -1:]
        else:
            x = x[:, int(last_pos):int(last_pos) + 1]
        x = apply_norm(cfg, params["final_norm"], x)
        return par.lm_logits(params["embed"], x, cfg), caches

    def decode_step(self, params, caches, inputs, pos, capacities=None,
                    par: Parallel = SINGLE):
        """One-token decode.  ``inputs``: (B,1) tokens (or ``{"tokens":
        ...}``), or for an embeds-input model ``{"embeds": (B,1,d),
        "positions": (B,1)|(B,3,1)}``; ``pos``: scalar or per-slot (B,)
        positions.  Returns (logits (B,1,V), caches) — the caches are
        updated in place.  With ``cfg.decode_sample`` the first element is
        the argmax tokens.  ``capacities`` is passed on as the reference
        passes it; the decode's dropless MoE takes none."""
        cfg = self.cfg
        if cfg.input_mode == "embeds" and not cfg.is_enc_dec:
            x = inputs["embeds"].to(dtype_of(cfg.compute_dtype))
            positions = inputs["positions"]
        else:
            tok = inputs["tokens"] if isinstance(inputs, dict) else inputs
            x = par.embed_tokens(params["embed"], tok, cfg)
            positions = None     # attention ropes with ``pos``
        x, caches, _ = apply_stack(
            params["stack"], cfg, x, mode="decode", positions=positions,
            caches=caches, pos=torch.as_tensor(pos, device=x.device),
            capacities=capacities, pattern=dec_pattern(cfg), par=par)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = par.lm_logits(params["embed"], x, cfg)
        if cfg.decode_sample:
            return torch.argmax(logits, dim=-1).to(torch.int32), caches
        return logits, caches
