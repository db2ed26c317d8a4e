"""whisper-medium [audio]: enc-dec, conv frontend (stub). 24L d_model=1024
16H (kv=16) d_ff=4096 vocab=51865 [arXiv:2212.04356; unverified]

24 encoder + 24 decoder layers; the audio frontend is a STUB — input_specs()
provides precomputed frame embeddings (B, T, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=48,          # 24 enc + 24 dec
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    dec_max_len=448,
    norm_type="layernorm",
    mlp_act="gelu",
    tie_embeddings=True,
    modality="audio",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, dec_max_len=32,
    )
