"""Jamba-v0.1 52B [arXiv:2403.19887] (hybrid Mamba+attention, MoE).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; attention every 8th
layer (offset 4), MoE every 2nd layer (offset 1): period-8 pattern
[M, M+moe, M, M+moe, A, M+moe, M, M+moe].  16 experts top-2
(d_expert=14336).  Jamba ships Mamba-1 blocks; we use the Mamba-2/SSD block
as the TPU-native equivalent (DESIGN.md deviation), d_state 16, expand 2
(d_inner 8192, 128 ssd-heads of 64).
"""

from ..models.config import LayerSpec, ModelConfig, MoEConfig, SSMConfig

ARCH = "jamba-v0.1-52b"

_PATTERN = (
    LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe"),
    LayerSpec("attn", "dense"), LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=65536, head_dim=128,
        layer_pattern=_PATTERN,
        moe=MoEConfig(n_routed=16, top_k=2, d_expert=14336,
                      router_aux_coef=0.001),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        rope_theta=1e6, sharding_policy="fsdp_tp",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-reduced", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        layer_pattern=tuple(
            LayerSpec(s.mixer, s.mlp) for s in _PATTERN
        ),
        moe=MoEConfig(n_routed=4, top_k=2, d_expert=32, capacity_factor=4.0),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=16),
        rope_theta=1e4,
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
