"""Mamba2-2.7B [arXiv:2405.21060] (SSD, attention-free).

64L d_model=2560, ssm_state=128, headdim=64, expand=2 (d_inner 5120, 80
heads), conv 4, n_groups=1; vocab 50280 padded to 50304 (GPT-NeoX padding).
"""

from ..models.config import LayerSpec, ModelConfig, SSMConfig

ARCH = "mamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=64, d_model=2560, n_heads=16, n_kv_heads=16,
        d_ff=0, vocab_size=50280, head_dim=128, vocab_pad_to=2048,
        layer_pattern=(LayerSpec("mamba", "none"),),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        tie_embeddings=True, sharding_policy="fsdp_tp",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=256, head_dim=16,
        layer_pattern=(LayerSpec("mamba", "none"),),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=16),
        tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
