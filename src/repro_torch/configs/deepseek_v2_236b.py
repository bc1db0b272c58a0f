"""DeepSeek-V2 236B [arXiv:2405.04434].

60L d_model=5120 128H MLA (q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128) vocab=102400; layer 0 dense (ffn 12288), layers 1-59 MoE: 160 routed
top-6 (intermediate 1536) + 2 shared (2x1536); routed_scaling_factor 16,
gates are raw softmax probs (no top-k renorm).  EP: 160/16 = 10 experts/chip.
"""

from ..models.config import LayerSpec, MLAConfig, ModelConfig, MoEConfig

ARCH = "deepseek-v2-236b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12288, vocab_size=102400, head_dim=128,
        prefix_pattern=(LayerSpec("mla", "dense"),),
        layer_pattern=(LayerSpec("mla", "moe"),),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(n_routed=160, top_k=6, d_expert=1536, n_shared=2,
                      d_shared=3072, normalize_topk=False, routed_scaling=16.0,
                      router_aux_coef=0.003),
        rope_theta=1e4, sharding_policy="fsdp_tp",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-reduced", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        prefix_pattern=(LayerSpec("mla", "dense"),),
        layer_pattern=(LayerSpec("mla", "moe"),),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_routed=8, top_k=2, d_expert=16, n_shared=2,
                      d_shared=32, normalize_topk=False, routed_scaling=2.0,
                      capacity_factor=4.0),
        rope_theta=1e4,
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )
