"""minicpm3-4b [dense]: MLA attention. 62L d_model=2560 40H d_ff=6400
vocab=73448 [hf:openbmb/MiniCPM3-4B; hf]

MLA dims follow the published checkpoint: q_lora 768, kv_lora 256,
qk rope/nope 32/64, v_head 64.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,       # MLA: logical kv = heads; the cache stores latents
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_rope_dim=32,
    qk_nope_dim=64,
    v_head_dim=64,
    norm_type="rmsnorm",
    mlp_act="silu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, q_lora_rank=32, kv_lora_rank=16,
        qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
    )
