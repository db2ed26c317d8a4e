"""recurrentgemma-2b [hybrid]: RG-LRU + local attn, 1:2. 26L d_model=2560
10H (kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427; hf]

Pattern (rec, rec, attn) tiled over 26 layers (8 groups + 2 rec tail);
local attention window 2048, MQA, head_dim 256, GeGLU MLP.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    attn_window=2048,
    conv_kernel=4,
    norm_type="rmsnorm",
    mlp_act="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, lru_width=64, attn_window=16,
    )
