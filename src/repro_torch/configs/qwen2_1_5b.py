"""Qwen2-1.5B [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936; QKV bias, tied
embeddings.  TP note: 12 q-heads pad to 16 for the 16-way model axis.
"""

from ..models.config import LayerSpec, ModelConfig

ARCH = "qwen2-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, head_dim=128,
        layer_pattern=(LayerSpec("attn", "dense"),),
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True, tp_pad_heads=16,
        sharding_policy="tp",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        layer_pattern=(LayerSpec("attn", "dense"),),
        qkv_bias=True, rope_theta=1e4, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
