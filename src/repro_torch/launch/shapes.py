"""Assigned input shapes × per-(arch, shape) input specs — the port of
``repro.launch.shapes``.

The four assigned LM shapes:
  train_4k     seq 4096   global_batch 256   → train_step
  prefill_32k  seq 32768  global_batch 32    → serve prefill
  decode_32k   seq 32768  global_batch 128   → serve_step (1 token, 32k cache)
  long_500k    seq 524288 global_batch 1     → serve_step (sub-quadratic only)

Each spec is a tensor on the meta device (PyTorch's ``ShapeDtypeStruct``):
the reference's shape and dtype, nothing allocated — the dry run's
contract.

Family mapping notes:
  * [vlm]: seq_len budget covers ``n_modality_positions`` stub patch
    embeddings prepended to text tokens (text len = seq − P).
  * [audio] enc-dec: seq_len = encoder frames (stub embeddings); the decoder
    operates on its own dec_max_len window (whisper: 448).
  * long_500k is SKIPPED for pure full-attention archs (quadratic), RUNS for
    ssm/hybrid.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig

f32 = torch.float32
bf16 = torch.bfloat16
i32 = torch.int32

__all__ = ["ShapeConfig", "SHAPES", "cell_supported", "sds", "train_batch_specs",
           "prefill_batch_specs", "decode_token_specs", "cache_shapes"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        Sd = cfg.dec_max_len
        return {
            "frames": sds((B, S, cfg.d_model), bf16),
            "tokens": sds((B, Sd), i32),
            "labels": sds((B, Sd), i32),
            "weights": sds((B,), f32),
        }
    batch = {}
    S_text = S
    if cfg.modality == "vision":
        P = cfg.n_modality_positions
        S_text = S - P
        batch["patch_embeds"] = sds((B, P, cfg.d_model), bf16)
    batch.update(
        {
            "tokens": sds((B, S_text), i32),
            "labels": sds((B, S_text), i32),
            "weights": sds((B,), f32),
        }
    )
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {
            "frames": sds((B, S, cfg.d_model), bf16),
            "tokens": sds((B, cfg.dec_max_len), i32),
        }
    batch = {}
    S_text = S
    if cfg.modality == "vision":
        P = cfg.n_modality_positions
        S_text = S - P
        batch["patch_embeds"] = sds((B, P, cfg.d_model), bf16)
    batch["tokens"] = sds((B, S_text), i32)
    return batch


def decode_token_specs(shape: ShapeConfig) -> torch.Tensor:
    return sds((shape.global_batch, 1), i32)


def cache_shapes(model, cfg: ModelConfig, shape: ShapeConfig):
    """(cache of meta tensors, logical specs) for the serve cache of
    ``init_cache(global_batch, seq_len)`` (``model`` is unused: the port
    derives the cache from ``cfg``, as the reference's specs are)."""
    from repro_torch.models.transformer import cache_shapes_and_specs

    del model
    return cache_shapes_and_specs(cfg, shape.global_batch, shape.seq_len)
