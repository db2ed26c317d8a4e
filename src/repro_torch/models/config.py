"""Model configuration: the port's own copy of ``repro.models.config``.

One frozen dataclass covers every family (dense / moe / ssm / hybrid /
encdec / vlm / audio); family-specific fields default to "off". Each
architecture instantiates it in ``repro_torch/configs/<id>.py`` with the
exact published numbers and provides ``reduced()`` for CPU tests. The fields
and defaults are the reference's, so a config converts field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention / position
    attn_type: str = "gqa"            # "gqa" | "mla"
    rope_theta: float = 10_000.0
    logits_softcap: float = 0.0

    # norm / mlp / embeddings
    norm_type: str = "rmsnorm"        # "rmsnorm" | "nonparametric_ln" | "layernorm"
    mlp_act: str = "silu"             # "silu" (SwiGLU) | "gelu" (GeGLU)
    tie_embeddings: bool = True
    scale_embeddings: bool = False    # gemma-style sqrt(d_model) input scaling

    # MLA (minicpm3 / deepseek-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    conv_kernel: int = 4
    ssm_chunk: int = 256

    # hybrid (recurrentgemma)
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    attn_window: int = 0              # 0 → global attention

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    dec_max_len: int = 448

    # modality frontend stub
    modality: str = "text"            # "text" | "vision" | "audio"
    n_modality_positions: int = 0     # vision: patch count prepended to text

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"      # master copy dtype (optimizer)

    # ---- performance knobs (§Perf hillclimbing) ----
    decode_seq_shard: bool = False    # shard decode KV cache seq-dim over the
                                      # model axis (flash-decode partial-softmax
                                      # combine) — the MQA/GQA long-cache fix
    scan_dtype: str = "float32"       # RG-LRU / SSD recurrent-state dtype
    moe_pad_experts: int = 0          # pad expert count to a mesh-divisible
                                      # value (dummy experts are never routed);
                                      # fixes EP sharding when E % mesh != 0
    prefill_flash_block: int = 0      # >0: blocked online-softmax attention on
                                      # the XLA path for long full-causal
                                      # sequences (kills S×S score buffers)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if decode memory/compute are sub-quadratic in context length."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
