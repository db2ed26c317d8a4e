"""tinyllama-1.1b [dense]: llama2-arch small. 22L d_model=2048 32H (GQA kv=4)
d_ff=5632 vocab=32000 [arXiv:2401.02385; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    norm_type="rmsnorm",
    mlp_act="silu",
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=256,
    )
