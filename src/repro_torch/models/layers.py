"""Layers of the decoder LMs the port serves (``repro/models/layers.py``).

The subset the dense (GQA) and SSM families need on the serving path. Each
function keeps the reference's name, argument order and weight layout
(``wq`` (d, H, hd), ``wo`` (H, hd, d), ...), so a test feeds both the same
numbers. Parameters are mappings of tensors; the init functions take an
explicit ``torch.Generator`` and return float32 tensors, which ``Model``
stores once in the dtype the reference casts them to at each use
(``param_dtype``).

Attention with a cache routes as follows:

- prefill into an empty cache (S > 1, scalar ``pos == 0``): causal attention
  over the fresh q/k/v through the flash-attention kernel, then k/v are
  written into the cache. It is the function of ``_sdpa`` over the cache
  with the ``kpos <= qpos`` mask, whose masked keys weigh exactly 0.
- decode (S == 1, scalar or per-slot ``pos``): plain PyTorch mirroring
  ``_sdpa`` and ``_vector_pos_decode``; no TPU kernel computes it.
- anything else raises ``NotImplementedError`` naming the ROADMAP item.

A scalar ``pos`` is a 0-d int32 tensor on the host (reading it costs no
device sync); a per-slot ``pos`` is a (B,) int32 tensor on the cache's
device. Caches are written in place (the reference returns new arrays):
the returned dict holds the same buffers and the advanced ``pos``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig

Params = dict

# parameters the reference uses in float32; every other one it casts to the
# activation dtype at each use
F32_PARAMS = frozenset({"scale", "bias", "A_log", "dt_bias", "norm_scale"})

TRAINING_ITEM = "ROADMAP.md Queue A 14: the LM training path"


def param_dtype(name: str, cfg: ModelConfig) -> torch.dtype:
    return torch.float32 if name in F32_PARAMS else getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, in_dim: int, out_shape) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, on the generator's device."""
    shape = (in_dim,) + tuple(np.atleast_1d(out_shape))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * float(1.0 / np.sqrt(in_dim))


def embed_init(generator: torch.Generator, vocab: int, dim: int) -> torch.Tensor:
    t = torch.empty((vocab, dim), dtype=torch.float32, device=generator.device)
    return t.normal_(generator=generator) * 0.02


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device=None) -> Params:
    if cfg.norm_type == "nonparametric_ln":
        return {}
    ones = torch.ones((cfg.d_model,), device=device)
    if cfg.norm_type == "layernorm":
        return {"scale": ones, "bias": torch.zeros((cfg.d_model,), device=device)}
    return {"scale": ones}


def apply_norm(params: Params, x: torch.Tensor, norm_type: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if norm_type == "rmsnorm":
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (xf * params["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    if norm_type == "layernorm":
        xf = xf * params["scale"].float() + params["bias"].float()
    return xf.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding (half-rotation / llama convention)
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S) int."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs
    if ang.ndim == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA / MQA; global attention over a linear cache)
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    return {
        "wq": dense_init(generator, d, (cfg.n_heads, cfg.head_dim)),
        "wk": dense_init(generator, d, (cfg.n_kv_heads, cfg.head_dim)),
        "wv": dense_init(generator, d, (cfg.n_kv_heads, cfg.head_dim)),
        "wo": dense_init(generator, cfg.q_dim, (d,)).reshape(cfg.n_heads, cfg.head_dim, d),
    }


def _sdpa(q, k, v, mask, logits_softcap: float = 0.0):
    """Reference scaled-dot-product attention (fp32 softmax).

    q: (B, S, H, hd), k/v: (B, T, KV, hd) — H % KV == 0 (GQA broadcast).
    mask: (B, 1, S, T) or (S, T) boolean, True = attend.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores / float(np.sqrt(hd))
    if logits_softcap > 0:
        scores = logits_softcap * torch.tanh(scores / logits_softcap)
    mask = mask[None, None, None] if mask.ndim == 2 else mask[:, :, None]
    scores = scores.masked_fill(~mask, -1e30)  # a Python fill: no host-to-device copy
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v).reshape(B, S, H, hd)


def causal_mask(S: int, T: int, offset: int = 0, window: int = 0, device=None) -> torch.Tensor:
    """(S, T) boolean mask: query i attends key j iff j ≤ i+offset (and within window)."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def _vector_pos_decode(params, q, k, v, cache, cfg):
    """Single-token decode with per-row cache positions (continuous batching).

    q/k/v: (B, 1, H|KV, hd); cache['pos']: (B,) int32 on the cache's device.
    Linear caches only (the ring cache waits with the hybrid family).

    A row whose pos has run past the cache (a finished slot the engine
    keeps ticking until a new request takes it) writes nothing, as the
    reference's ``.at[rows, pos].set`` drops an out-of-range write: its
    index is clamped and the old entry written back.
    """
    B = q.shape[0]
    pos = cache["pos"]
    K, V = cache["k"], cache["v"]
    L = K.shape[1]
    rows = torch.arange(B, device=K.device)
    idx = pos.clamp(max=L - 1).long()
    live = (pos < L)[:, None, None]
    K[rows, idx] = torch.where(live, k[:, 0].to(K.dtype), K[rows, idx])
    V[rows, idx] = torch.where(live, v[:, 0].to(V.dtype), V[rows, idx])
    mask = torch.arange(L, device=K.device)[None, :] <= pos[:, None]
    out = _sdpa(q, K.to(q.dtype), V.to(q.dtype), mask[:, None, None, :], cfg.logits_softcap)
    return out, {"k": K, "v": V, "pos": pos + 1}


def _check_routable(cfg: ModelConfig, cache, window: int, bidirectional: bool, use_rope: bool):
    if cache is None:
        raise NotImplementedError(f"attention without a cache: {TRAINING_ITEM}")
    if window > 0:
        raise NotImplementedError(
            "local attention / ring cache: ROADMAP.md Queue A 14, hybrid with ring-cache "
            "local attention (recurrentgemma)"
        )
    if bidirectional or not use_rope:
        raise NotImplementedError("encoder / rope-free attention: ROADMAP.md Queue A 14, encdec")
    if cfg.logits_softcap > 0:
        raise NotImplementedError(
            "logit soft-capping: ROADMAP.md Queue A 14, further dense configs (olmo-1b, gemma-2b)"
        )
    if cfg.attn_type != "gqa":
        raise NotImplementedError("MLA attention: ROADMAP.md Queue A 14, MLA (minicpm3)")


def attention_apply(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Params | None = None,
    window: int = 0,
    bidirectional: bool = False,
    use_rope: bool = True,
) -> tuple[torch.Tensor, Params]:
    """Returns (out, new_cache); cache = {'k', 'v', 'pos'} is a linear buffer."""
    _check_routable(cfg, cache, window, bidirectional, use_rope)
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"].reshape(d, H * hd)).reshape(B, S, H, hd)
    k = (x @ params["wk"].reshape(d, KV * hd)).reshape(B, S, KV, hd)
    v = (x @ params["wv"].reshape(d, KV * hd)).reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    pos = cache["pos"]
    if pos.ndim == 1:
        if S != 1:
            raise NotImplementedError(
                f"multi-token steps with per-slot positions: {TRAINING_ITEM} (chunked prefill)"
            )
        out, new_cache = _vector_pos_decode(params, q, k, v, cache, cfg)
    else:
        p = int(pos)
        K, V = cache["k"], cache["v"]
        if S > 1 and p != 0:
            raise NotImplementedError(
                f"prefill into a non-empty cache (pos = {p}): {TRAINING_ITEM} (chunked prefill)"
            )
        if p + S > K.shape[1]:
            raise ValueError(f"cache of {K.shape[1]} positions cannot take {S} more at {p}")
        K[:, p:p + S] = k.to(K.dtype)
        V[:, p:p + S] = v.to(V.dtype)
        if S > 1:
            out = flash_attention(q, k, v, causal=True)
        else:
            mask = causal_mask(S, K.shape[1], p, device=K.device)
            out = _sdpa(q, K.to(x.dtype), V.to(x.dtype), mask, cfg.logits_softcap)
        new_cache = {"k": K, "v": V, "pos": pos + S}
    return out.reshape(B, S, H * hd) @ params["wo"].reshape(H * hd, d), new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, device=None) -> Params:
    """Stacked-over-layers KV cache (zeros) with a scalar host-side ``pos``."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32),
    }


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, cfg: ModelConfig, d_ff: int | None = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": dense_init(generator, d, (f,)),
        "wi_up": dense_init(generator, d, (f,)),
        "wo": dense_init(generator, f, (d,)),
    }


def mlp_apply(params: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    gate = x @ params["wi_gate"]
    up = x @ params["wi_up"]
    a = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return (a * up) @ params["wo"]


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def init_embeddings(generator: torch.Generator, cfg: ModelConfig) -> Params:
    p = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(generator, cfg.vocab_size, cfg.d_model)
    return p


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    x = params["embed"].to(dtype)[tokens]
    if cfg.scale_embeddings:
        x = x * float(np.sqrt(cfg.d_model))
    return x


def logits_from_hidden(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = params["unembed"] if "unembed" in params else params["embed"]
    return x @ table.to(x.dtype).T
