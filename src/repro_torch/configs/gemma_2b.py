"""gemma-2b [dense]: GeGLU, head_dim=256, MQA. 18L d_model=2048 8H (kv=1)
d_ff=16384 vocab=256000 [arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,        # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    norm_type="rmsnorm",
    mlp_act="gelu",      # GeGLU
    tie_embeddings=True,
    scale_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512,
    )
