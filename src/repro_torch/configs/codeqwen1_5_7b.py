"""CodeQwen1.5-7B [hf Qwen/CodeQwen1.5-7B] (qwen1.5 arch, MHA).

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416; QKV bias, rope 1e6.
"""

from ..models.config import LayerSpec, ModelConfig

ARCH = "codeqwen1.5-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13440, vocab_size=92416, head_dim=128,
        layer_pattern=(LayerSpec("attn", "dense"),),
        qkv_bias=True, rope_theta=1e6, sharding_policy="fsdp_tp",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        layer_pattern=(LayerSpec("attn", "dense"),),
        qkv_bias=True, rope_theta=1e4,
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
