"""Model configuration dataclasses covering all assigned architecture families.

One ``ModelConfig`` describes dense / GQA / MLA / MoE / SSM / hybrid / enc-dec
stacks.  Layer stacking is pattern-based: ``layer_pattern`` lists the layers of
one *period*; the stack is ``prefix_layers`` (unrolled, e.g. deepseek's first
dense layer) followed by ``(n_layers - prefix) / len(pattern)`` scanned
periods.  Scanning keeps XLA compile time depth-independent.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "mla", "mamba"]
Mlp = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    mlp: Mlp = "dense"
    cross_attn: bool = False  # decoder layers of enc-dec models


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_expert: int               # per-expert intermediate size
    n_shared: int = 0
    d_shared: int = 0           # shared-expert intermediate size (total)
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    normalize_topk: bool = True
    routed_scaling: float = 1.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack of enc-dec models (decoder fields live on ModelConfig)."""

    n_layers: int = 12
    # encoder reuses d_model / n_heads / d_ff from the parent config


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # families / options
    layer_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    prefix_pattern: tuple[LayerSpec, ...] = ()     # unrolled leading layers
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    mla: MLAConfig | None = None
    encoder: EncoderConfig | None = None           # present => enc-dec
    input_mode: Literal["tokens", "embeds"] = "tokens"   # vlm/audio stubs feed embeds
    mrope_sections: tuple[int, int, int] | None = None   # qwen2-vl M-RoPE

    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    attn_chunk: int = 1024        # jnp flash chunking threshold / q-block
    attn_chunk_k: int = 0         # kv-block size (0 = same as attn_chunk)
    cache_update: Literal["dus", "onehot"] = "dus"

    # embeddings / head
    tie_embeddings: bool = False
    vocab_pad_to: int = 128       # pad vocab for TP divisibility
    tp_pad_heads: int = 0         # pad q-heads to this count for TP (0 = off)

    # norm / numerics
    norm_eps: float = 1e-6
    use_layernorm: bool = False   # seamless uses LayerNorm, rest RMSNorm
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"

    # distribution hints (consumed by sharding/policy.py)
    sharding_policy: Literal["tp", "fsdp_tp"] = "tp"

    # kernels
    use_pallas: bool | None = None   # None = auto (TPU only)

    # dry-run/roofline accounting: fully unroll the layer scan so
    # HloCostAnalysis (which visits while bodies once) sees every layer.
    full_unroll: bool = False

    # ---- performance knobs (§Perf iterations) ----
    seq_parallel: bool = False    # shard residual-stream seq dim over `model`
    decode_sample: bool = False   # decode_step returns argmax tokens, not logits
                                  # (kills the (B,1,V) gather: argmax reduces
                                  # over the V-sharded dim on-device)
    ce_chunk: int = 0             # >0: fused chunked cross-entropy (no (B,S,V) live)
    remat_policy: str = "nothing"  # nothing | dots (dots_with_no_batch_dims_saveable)
    cache_dtype: str = ""          # decode cache storage dtype ("" = compute_dtype)

    # -- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return (self.vocab_size + m - 1) // m * m

    @property
    def n_q_heads(self) -> int:
        """Q heads after optional TP padding (extra heads are dead weight,
        the Megatron vocab-padding trick applied to heads)."""
        return max(self.n_heads, self.tp_pad_heads)

    @property
    def n_periods(self) -> int:
        body = self.n_layers - len(self.prefix_pattern)
        if body % len(self.layer_pattern):
            raise ValueError(
                f"{self.name}: {body} body layers not divisible by pattern "
                f"of {len(self.layer_pattern)}"
            )
        return body // len(self.layer_pattern)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder is not None

    def validate(self) -> "ModelConfig":
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: kv heads must divide q heads")
        if self.tp_pad_heads and self.tp_pad_heads < self.n_heads:
            raise ValueError(f"{self.name}: tp_pad_heads < n_heads")
        _ = self.n_periods
        for spec in self.layer_pattern + self.prefix_pattern:
            if spec.mixer == "mamba" and self.ssm is None:
                raise ValueError(f"{self.name}: mamba layer without ssm config")
            if spec.mixer == "mla" and self.mla is None:
                raise ValueError(f"{self.name}: mla layer without mla config")
            if spec.mlp == "moe" and self.moe is None:
                raise ValueError(f"{self.name}: moe layer without moe config")
        return self
