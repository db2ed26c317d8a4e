"""mamba2-370m [ssm]: SSD (state-space duality). 48L d_model=1024 (attn-free)
vocab=50280, ssm_state=128 [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,          # d_inner / headdim = 2048/64
    n_kv_heads=32,
    head_dim=64,
    d_ff=0,              # pure mamba blocks, no MLP
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    conv_kernel=4,
    ssm_chunk=256,
    norm_type="rmsnorm",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        vocab_size=256, ssm_state=16, ssm_headdim=32, ssm_chunk=16,
    )
