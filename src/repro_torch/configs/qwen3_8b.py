"""Qwen3-8B [hf Qwen/Qwen3-8B].

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936; per-head QK-RMSNorm,
no QKV bias, rope 1e6.
"""

from ..models.config import LayerSpec, ModelConfig

ARCH = "qwen3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12288, vocab_size=151936, head_dim=128,
        layer_pattern=(LayerSpec("attn", "dense"),),
        qk_norm=True, rope_theta=1e6, sharding_policy="fsdp_tp",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        layer_pattern=(LayerSpec("attn", "dense"),),
        qk_norm=True, rope_theta=1e4,
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
