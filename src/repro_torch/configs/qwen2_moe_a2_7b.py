"""Qwen1.5-MoE-A2.7B [hf Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (MHA kv=16) vocab=151936; every layer MoE: 60 routed
top-4 (intermediate 1408) + shared expert 5632 (= 4x1408, the '4 shared').
norm_topk_prob=False per the HF config.  EP 60 % 16 != 0 => expert-TP on the
1408 ff dim (DESIGN.md §5).
"""

from ..models.config import LayerSpec, ModelConfig, MoEConfig

ARCH = "qwen2-moe-a2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=5632, vocab_size=151936, head_dim=128,
        layer_pattern=(LayerSpec("attn", "moe"),),
        moe=MoEConfig(n_routed=60, top_k=4, d_expert=1408,
                      n_shared=1, d_shared=5632, normalize_topk=False,
                      router_aux_coef=0.001),
        qkv_bias=True, rope_theta=1e6, sharding_policy="fsdp_tp",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        layer_pattern=(LayerSpec("attn", "moe"),),
        moe=MoEConfig(n_routed=8, top_k=4, d_expert=32, n_shared=1,
                      d_shared=128, normalize_topk=False, capacity_factor=4.0),
        qkv_bias=True, rope_theta=1e4,
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
