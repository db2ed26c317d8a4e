"""Encoder-decoder pieces (whisper-style): cross-attention and sinusoidal
positions, the port of ``repro/models/encdec.py``.

The audio frontend (log-mel and conv downsampling) is a stub, as in the
reference: callers hand in precomputed frame embeddings (B, T_frames,
d_model). Cross-attention is plain PyTorch, as the reference's einsums are:
its queries have the decoder's length and its keys the frames', and the
flash-attention kernel (the reference's and the port's) takes q and k of
one length.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _sdpa, dense_init

Params = dict


@functools.lru_cache(maxsize=8)
def _sinusoid_table(T: int, D: int) -> np.ndarray:
    pos = np.arange(T)[:, None]
    div = np.exp(np.arange(0, D, 2) * (-np.log(10000.0) / D))
    pe = np.zeros((T, D), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    pe.flags.writeable = False
    return pe


def sinusoid_pos(T: int, D: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(T, D) sinusoidal positions, computed in numpy as the reference
    computes them (the same float32 bits), then cast to ``dtype``."""
    return torch.tensor(_sinusoid_table(T, D), dtype=dtype, device=device)


def init_cross_attention(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    return {
        "wq": dense_init(generator, d, (cfg.n_heads, cfg.head_dim)),
        "wk": dense_init(generator, d, (cfg.n_kv_heads, cfg.head_dim)),
        "wv": dense_init(generator, d, (cfg.n_kv_heads, cfg.head_dim)),
        "wo": dense_init(generator, cfg.q_dim, (d,)).reshape(cfg.n_heads, cfg.head_dim, d),
    }


def cross_kv(params: Params, memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V (B, T, KV, hd) of the encoder's output (computed
    once a request)."""
    k = torch.einsum("btd,dhk->bthk", memory, params["wk"].to(memory.dtype))
    v = torch.einsum("btd,dhk->bthk", memory, params["wv"].to(memory.dtype))
    return k, v


def cross_attention_apply(params: Params, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """The decoder's queries x (B, S, d) against every key of k/v."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
