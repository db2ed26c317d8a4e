"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend (stub).

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    norm_type="rmsnorm",
    mlp_act="silu",
    tie_embeddings=False,
    modality="vision",
    n_modality_positions=256,  # stub patch embeddings prepended to text
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, n_modality_positions=8,
    )
