"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf Qwen/Qwen2-VL-7B-Instruct].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064; M-RoPE sections
(16,24,24); dynamic-resolution vision frontend is a STUB — input_specs feed
precomputed patch embeddings (B,S,3584) + (B,3,S) M-RoPE position ids.
TP note: 28 q-heads pad to 32 for the 16-way model axis (DESIGN.md §4).
"""

from ..models.config import LayerSpec, ModelConfig

ARCH = "qwen2-vl-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064, head_dim=128,
        layer_pattern=(LayerSpec("attn", "dense"),),
        input_mode="embeds", mrope_sections=(16, 24, 24),
        qkv_bias=True, rope_theta=1e6, tp_pad_heads=32,
        sharding_policy="fsdp_tp",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        layer_pattern=(LayerSpec("attn", "dense"),),
        input_mode="embeds", mrope_sections=(2, 3, 3),
        qkv_bias=True, rope_theta=1e4,
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
