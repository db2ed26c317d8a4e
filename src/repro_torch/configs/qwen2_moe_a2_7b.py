"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed top-4. 24L d_model=2048 16H
(kv=16) d_ff=1408 vocab=151936 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,   # shared-expert FFN of width 4·d_ff, always active
    norm_type="rmsnorm",
    mlp_act="silu",
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, vocab_size=256, n_experts=8, top_k=2, n_shared_experts=1,
        capacity_factor=8.0,
    )
