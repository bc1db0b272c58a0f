"""Granite-34B-Code [arXiv:2405.04324] (llama-arch, MQA).

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.  MQA => KV cache is
tiny per token but the 1 KV head cannot TP-shard: decode shards the cache on
the sequence dim over `model` (DESIGN.md §5).
"""

from ..models.config import LayerSpec, ModelConfig

ARCH = "granite-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab_size=49152, head_dim=128,
        layer_pattern=(LayerSpec("attn", "dense"),),
        qkv_bias=True, rope_theta=1e5, tie_embeddings=True,
        sharding_policy="fsdp_tp",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab_size=256, head_dim=16,
        layer_pattern=(LayerSpec("attn", "dense"),),
        qkv_bias=True, rope_theta=1e4, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
