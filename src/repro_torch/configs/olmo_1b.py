"""olmo-1b [dense]: non-parametric LN. 16L d_model=2048 16H (kv=16) d_ff=8192
vocab=50304 [arXiv:2402.00838; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparametric_ln",  # OLMo's parameter-free LayerNorm
    mlp_act="silu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
    )
