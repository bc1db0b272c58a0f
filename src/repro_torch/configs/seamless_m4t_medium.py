"""SeamlessM4T-medium backbone [arXiv:2308.11596] (enc-dec, multimodal).

12L encoder + 12L decoder, d_model=1024 16H d_ff=4096 vocab=256206 (padded to
256256 for 16-way TP of the embedding/vocab dims).  The speech/text frontend
is a STUB: input_specs feed precomputed frame embeddings (B, S_src, 1024).
LayerNorm (not RMSNorm); rope on self-attention (positional simplification
noted in DESIGN.md), cross-attention without positional mixing.
"""

from ..models.config import EncoderConfig, LayerSpec, ModelConfig

ARCH = "seamless-m4t-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=256206, head_dim=64, vocab_pad_to=2048,
        layer_pattern=(LayerSpec("attn", "dense"),),
        encoder=EncoderConfig(n_layers=12),
        use_layernorm=True, rope_theta=1e4, sharding_policy="tp",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=250, head_dim=16, vocab_pad_to=128,
        layer_pattern=(LayerSpec("attn", "dense"),),
        encoder=EncoderConfig(n_layers=2),
        use_layernorm=True, rope_theta=1e4,
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
