"""Layers of the decoder LMs the port serves and trains
(``repro/models/layers.py``).

The subset the dense (GQA and MLA), MoE, SSM, hybrid and encoder-decoder
families need. Each
function keeps the reference's name, argument order and weight layout
(``wq`` (d, H, hd), ``wo`` (H, hd, d), ...), so a test feeds both the same
numbers. Parameters are mappings of tensors; the init functions take an
explicit ``torch.Generator`` and return float32 tensors (``init_moe`` its
expert stacks in the dtype asked for). Each weight is cast to the
activation dtype at use, as the reference casts its float32 masters: a
serving ``Model`` stores the weights in that dtype already
(``param_dtype``), where the cast is a no-op; a training one keeps float32
masters.

Attention (rope on q and k unless ``use_rope=False``; every route applies
``cfg.logits_softcap`` but the kernel's, which none with a softcap takes)
routes as follows:

- no cache (training): ``_sdpa`` under ``causal_mask`` (with a local
  ``window``: its band, or ``local_attention_chunked`` when S exceeds it),
  or ``blocked_causal_attention`` when ``cfg.prefill_flash_block`` > 0 and
  S exceeds it, all plain PyTorch as in the reference (no Pallas kernel
  computes them there), so autograd differentiates them;
- no cache, ``bidirectional`` (the encoder's): every key attended, through
  the flash-attention kernel with ``causal=False`` when none of q, k, v
  requires grad (serving, or under ``torch.no_grad()``), else (training,
  or a softcap) through ``_sdpa`` under an all-ones mask;
- prefill into an empty cache (S > 1, scalar ``pos == 0``; with a local
  ``window``, S ≤ window; no softcap): causal attention over the fresh
  q/k/v through the
  flash-attention kernel, then k/v are written into the cache. It is the
  function of ``_sdpa`` over the cache with the ``kpos <= qpos`` mask (a
  ring cache's unwritten slots hold absolute positions < 0, and every key
  lies inside the window), whose masked keys weigh exactly 0. With a
  softcap it attends as the reference does: ``_sdpa`` over the cache, or
  ``blocked_causal_attention`` past ``cfg.prefill_flash_block``;
- a ring cache (local attention, cache length == window) taking S ≥ window
  tokens (but for a prefill from empty of exactly the window, which takes
  the kernel): ``local_attention_chunked`` over the fresh q/k/v, then the last W
  keys rolled into slots p % W, as the reference computes it in XLA (plain
  PyTorch: no Pallas kernel computes windowed attention there);
- chunked prefill (S > 1, scalar ``pos > 0``) and decode (S == 1, scalar or
  per-slot ``pos``): plain PyTorch mirroring ``_sdpa`` over the cache with
  the offset (and window, or ring-slot) mask and ``_vector_pos_decode``; no
  TPU kernel computes them;
- multi-token steps with per-slot positions raise ``NotImplementedError``
  (the reference has no such path).

MLA (``mla_apply``) is plain PyTorch on every path, as the reference's
einsums are: no cache (training), a scalar ``pos`` (prefill, chunked
prefill, batch decode: the latent is written in place and k/v are
materialised from the cache up to ``pos + S``; the keys past it weigh
exactly 0 under the reference's mask over the whole cache) and the
per-slot decode. MoE (``moe_apply``) dispatches with static capacity per
call, as the reference does; its top-k breaks ties toward the lower
expert index, as ``jax.lax.top_k`` does.

A scalar ``pos`` is a 0-d int32 tensor on the host (reading it costs no
device sync); a per-slot ``pos`` is a (B,) int32 tensor on the cache's
device. Caches are written in place (the reference returns new arrays):
the returned dict holds the same buffers and the advanced ``pos``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.distributed.sharding import (WHOLE, attention_blocks, constrain, embed_lookup,
                                              fsdp_gather, grad_splittable, heads_whole,
                                              local_blocks, split_first, split_last, take_last)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig

Params = dict

# parameters the reference uses in float32; every other one it casts to the
# activation dtype at each use
F32_PARAMS = frozenset({"scale", "bias", "A_log", "dt_bias", "norm_scale", "q_norm",
                        "kv_norm", "lam"})


def param_dtype(name: str, cfg: ModelConfig) -> torch.dtype:
    return torch.float32 if name in F32_PARAMS else getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, in_dim: int, out_shape) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, on the generator's device."""
    shape = (in_dim,) + tuple(np.atleast_1d(out_shape))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if not (t.is_meta or is_fake(t)):  # a fake tensor (the dry run's) has no values to draw
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
    # on DTensors, each rank's (rows, heads) block (``sharding.attention_blocks``)
    return attention_blocks(_sdpa_core, q, k, v, mask, logits_softcap,
                            rest_dims=(None if mask.ndim == 4 else WHOLE, None))


def _flash_core(q, k, v, causal: bool):
    return flash_attention(q, k, v, causal=causal)


def _flash(q, k, v, causal: bool):
    """The flash-attention kernel (its plain version off the card); on
    DTensors, each rank's (rows, heads) block (``sharding.attention_blocks``)."""
    return attention_blocks(_flash_core, q, k, v, causal, rest_dims=(None,))


def _sdpa_core(q, k, v, mask, logits_softcap: float = 0.0):
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


def blocked_causal_attention(q, k, v, block: int = 1024, logits_softcap: float = 0.0):
    """Full causal attention without the S×S score matrix, as the reference
    computes it: an outer loop over q blocks, an inner one over the k blocks
    up to the diagonal with an online-softmax accumulator (f32), so the
    score buffer is (H, block, block). The reference's plain twin of the
    flash-attention kernel; plain PyTorch, so autograd differentiates it."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    groups = H // KV
    pad = (-S) % block
    if pad:
        q = torch.cat([q, q.new_zeros((B, pad, H, hd))], 1)
        k = torch.cat([k, k.new_zeros((B, pad, KV, hd))], 1)
        v = torch.cat([v, v.new_zeros((B, pad, KV, hd))], 1)
    nb = (S + pad) // block
    scale = float(1.0 / np.sqrt(hd))
    qb = q.reshape(B, nb, block, KV, groups, hd)
    kb = k.reshape(B, nb, block, KV, hd)
    vb = v.reshape(B, nb, block, KV, hd)
    iota = torch.arange(block, device=q.device)
    outs = []
    for iq in range(nb):
        qi = qb[:, iq]
        acc = q.new_zeros((B, KV, groups, block, hd), dtype=torch.float32)
        m = q.new_full((B, KV, groups, block, 1), -1e30, dtype=torch.float32)
        l = q.new_zeros((B, KV, groups, block, 1), dtype=torch.float32)
        for j in range(iq + 1):
            s = torch.einsum("bqkgh,btkh->bkgqt", qi, kb[:, j]).float() * scale
            if logits_softcap > 0:
                s = logits_softcap * torch.tanh(s / logits_softcap)
            visible = (j * block + iota)[None, :] <= (iq * block + iota)[:, None]
            s = s.masked_fill(~visible, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            vj = vb[:, j]
            acc = acc * alpha + torch.einsum("bkgqt,btkh->bkgqh", p.to(vj.dtype), vj).float()
            m = m_new
        out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)  # (B, KV, G, bq, hd)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, bq, KV, G, hd)
    return torch.cat(outs, 1).reshape(B, S + pad, H, hd)[:, :S]


def local_attention_chunked(q, k, v, window: int, logits_softcap: float = 0.0):
    """Banded (local) causal attention without the S×S score matrix.

    Splits S into window-sized chunks; chunk i attends to chunks i−1 and i
    with the exact band mask: peak score memory W×2W per chunk instead of
    S×S. A loop over the chunks (the reference's scan).
    """
    B, S, H, hd = q.shape
    W = window
    KV = k.shape[2]
    pad = (-S) % W
    if pad:
        q = torch.cat([q, q.new_zeros((B, pad, H, hd))], 1)
        k = torch.cat([k, k.new_zeros((B, pad, KV, hd))], 1)
        v = torch.cat([v, v.new_zeros((B, pad, KV, hd))], 1)
    nc = (S + pad) // W
    qc = q.reshape(B, nc, W, H, hd)
    kc = k.reshape(B, nc, W, KV, hd)
    vc = v.reshape(B, nc, W, KV, hd)
    # key j (offset j − W from the chunk start) is visible to query i iff
    # 0 ≤ i − (j − W) < W; chunk 0 has no predecessor
    qpos = torch.arange(W, device=q.device)[:, None]
    kpos = torch.arange(2 * W, device=q.device)[None, :] - W
    band = (kpos <= qpos) & (kpos > qpos - W)
    outs = []
    for c in range(nc):
        kp = kc[:, c - 1] if c else torch.zeros_like(kc[:, 0])
        vp = vc[:, c - 1] if c else torch.zeros_like(vc[:, 0])
        mask = band if c else band & (kpos >= 0)
        outs.append(_sdpa(qc[:, c], torch.cat([kp, kc[:, c]], 1), torch.cat([vp, vc[:, c]], 1),
                          mask, logits_softcap))
    return torch.stack(outs, 1).reshape(B, S + pad, H, hd)[:, :S]


def _ring_slot_positions(total: torch.Tensor, W: int) -> torch.Tensor:
    """Absolute position held by each ring slot after ``total`` writes
    (``total`` (...,) → (..., W)); slots not yet written hold positions < 0."""
    i = torch.arange(W, device=total.device)
    return total[..., None] - 1 - ((total[..., None] - 1 - i) % W)


def _vector_pos_decode(params, q, k, v, cache, cfg, *, window: int = 0):
    """Single-token decode with per-row cache positions (continuous batching).

    q/k/v: (B, 1, H|KV, hd); cache['pos']: (B,) int32 on the cache's device.
    Linear caches (a write at pos_b, keys within ``window`` when it is set)
    and ring caches (cache length == window > 0: a write at pos_b % W, the
    mask from each slot's absolute position).

    A row whose pos has run past a linear cache (a finished slot the engine
    keeps ticking until a new request takes it) writes nothing, as the
    reference's ``.at[rows, pos].set`` drops an out-of-range write: its
    index is clamped and the old entry written back.
    """
    B = q.shape[0]
    pos = cache["pos"]
    K, V = cache["k"], cache["v"]
    L = K.shape[1]
    rows = torch.arange(B, device=K.device)
    if window > 0 and L == window:
        idx = (pos % window).long()
        K[rows, idx] = k[:, 0].to(K.dtype)
        V[rows, idx] = v[:, 0].to(V.dtype)
        abs_pos = _ring_slot_positions(pos + 1, window)  # (B, W)
        mask = ((abs_pos >= 0) & (abs_pos <= pos[:, None])
                & (abs_pos > pos[:, None] - window))
    else:
        idx = pos.clamp(max=L - 1).long()
        live = (pos < L)[:, None, None]
        K[rows, idx] = torch.where(live, k[:, 0].to(K.dtype), K[rows, idx])
        V[rows, idx] = torch.where(live, v[:, 0].to(V.dtype), V[rows, idx])
        kpos = torch.arange(L, device=K.device)[None, :]
        mask = kpos <= pos[:, None]
        if window > 0:
            mask &= kpos > pos[:, None] - window
    out = _sdpa(q, K.to(q.dtype), V.to(q.dtype), mask[:, None, None, :], cfg.logits_softcap)
    return out, {"k": K, "v": V, "pos": pos + 1}


def _check_routable(cfg: ModelConfig):
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"attention_apply is the GQA path: {cfg.attn_type!r} attention goes through mla_apply")


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
    """Returns (out, new_cache); cache = {'k', 'v', 'pos'} is a linear buffer
    (global attention, or local with ``window`` > the cache's length) or a
    ring buffer (local attention, cache length == ``window``), written in
    place; None without a cache (training: new_cache is None).
    ``use_rope=False`` leaves q and k unrotated; ``bidirectional`` (the
    encoder's) attends every key when there is no cache (with a cache the
    reference ignores it, and so does the port)."""
    _check_routable(cfg)
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    softcap = cfg.logits_softcap
    # redistribution point "head_split": a projection (or, in the backward,
    # a flattened weight's gradient) split over more ranks than it has
    # heads is gathered before its heads are unflattened
    def proj(w, heads):
        w = grad_splittable("head_split", w.to(x.dtype).reshape(d, heads * hd), 1, heads)
        return split_last("head_split", x @ w, (heads, hd))

    q, k, v = proj(params["wq"], H), proj(params["wk"], KV), proj(params["wv"], KV)
    # heads that do not split evenly over the model axes stay whole there
    q = heads_whole("head_split", q, H)
    k, v = heads_whole("head_split", k, KV), heads_whole("head_split", v, KV)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        if window > 0 and S > window:
            out = local_attention_chunked(q, k, v, window, softcap)
        elif bidirectional:
            # the kernel has no backward and no softcap: training and a
            # soft-capped config attend through _sdpa
            if softcap > 0 or any(t.requires_grad for t in (q, k, v)):
                out = _sdpa(q, k, v, torch.ones((S, S), dtype=torch.bool, device=x.device),
                            softcap)
            else:
                out = _flash(q, k, v, False)
        elif cfg.prefill_flash_block and window == 0 and S > cfg.prefill_flash_block:
            out = blocked_causal_attention(q, k, v, cfg.prefill_flash_block, softcap)
        else:
            out = _sdpa(q, k, v, causal_mask(S, S, 0, window, device=x.device), softcap)
        new_cache = None
    elif cache["pos"].ndim == 1:
        if S != 1:
            raise NotImplementedError(
                "multi-token steps with per-slot positions: the reference has no such path "
                "(ROADMAP.md Queue A, not ported by design)"
            )
        out, new_cache = _vector_pos_decode(params, q, k, v, cache, cfg, window=window)
    else:
        pos = cache["pos"]
        p = int(pos)
        K, V = cache["k"], cache["v"]
        T = K.shape[1]
        ring = window > 0 and T == window
        # a prefill from empty takes the kernel, which has no softcap: a
        # soft-capped one attends as the reference does
        kernel = S > 1 and p == 0 and softcap == 0
        if ring and S >= window and not (p == 0 and S == window and softcap == 0):
            # a ring cache taking at least a window: local attention over
            # the fresh tokens, then the last W keys at slots (p + i) % W
            # (from p > 0 the reference too attends only the fresh keys)
            out = local_attention_chunked(q, k, v, window, softcap)
            shift = (p + S) % window  # the slot of tail element 0 is (p + S − W) % W
            K.copy_(torch.roll(k[:, -window:].to(K.dtype), shift, 1))
            V.copy_(torch.roll(v[:, -window:].to(V.dtype), shift, 1))
        elif ring:
            # writes at slots (p + i) % W, masked by each slot's absolute position
            slots = (p + torch.arange(S, device=K.device)) % window
            K[:, slots] = k.to(K.dtype)
            V[:, slots] = v.to(V.dtype)
            if kernel:
                out = _flash(q, k, v, True)
            else:
                abs_pos = _ring_slot_positions(pos.to(K.device) + S, window)[None, :]
                qpos = p + torch.arange(S, device=K.device)[:, None]
                mask = (abs_pos >= 0) & (abs_pos <= qpos) & (abs_pos > qpos - window)
                out = _sdpa(q, K.to(x.dtype), V.to(x.dtype), mask, softcap)
        else:
            if p + S > T:
                raise ValueError(f"cache of {T} positions cannot take {S} more at {p}")
            K[:, p:p + S] = k.to(K.dtype)
            V[:, p:p + S] = v.to(V.dtype)
            if cfg.decode_seq_shard:
                # flash-decode: the cache stays sharded over the model axis
                # along its sequence dim (the reference's constraint)
                K = constrain(K, "batch", "model", None, None)
                V = constrain(V, "batch", "model", None, None)
            if kernel:
                out = _flash(q, k, v, True)
            elif cfg.prefill_flash_block and window == 0 and S > cfg.prefill_flash_block \
                    and p == 0:
                # a soft-capped long prefill from empty: the reference's
                # blocked attention over the fresh keys
                out = blocked_causal_attention(q, k, v, cfg.prefill_flash_block, softcap)
            else:
                # decode, or chunked prefill into a non-empty cache: the cache
                # up to each query's position (here the reference's
                # prefill_flash_block branch would attend only the fresh keys)
                mask = causal_mask(S, T, p, window, device=K.device)
                out = _sdpa(q, K.to(x.dtype), V.to(x.dtype), mask, softcap)
        new_cache = {"k": K, "v": V, "pos": pos + S}
    wo = grad_splittable("head_split", params["wo"].to(x.dtype).reshape(H * hd, d), 0, H)
    return grad_splittable("head_split", out.reshape(B, S, H * hd), 2, H) @ wo, new_cache


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
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek family)
# ---------------------------------------------------------------------------


def init_mla(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    r, dc = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = generator.device
    return {
        "wdq": dense_init(generator, d, (r,)),
        "q_norm": torch.ones((r,), device=dev),
        "wuq": dense_init(generator, r, (H, nope + rdim)),
        "wdkv": dense_init(generator, d, (dc,)),
        "kv_norm": torch.ones((dc,), device=dev),
        "wkr": dense_init(generator, d, (rdim,)),  # shared rope key (per token)
        "wuk": dense_init(generator, dc, (H, nope)),
        "wuv": dense_init(generator, dc, (H, vdim)),
        "wo": dense_init(generator, H * vdim, (d,)).reshape(H, vdim, d),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's ``_rms``: an RMS norm with a float32 scale."""
    return apply_norm({"scale": scale}, x, "rmsnorm", eps)


def mla_apply(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Params | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """MLA: the cache keeps a (kv_lora_rank + rope_dim) latent per token,
    ``{"ckv": (B, T, dc), "krope": (B, T, 1, rope_dim), "pos"}``, written in
    place; k and v are materialised from it at each call, as in the
    reference. Returns (out, new_cache), new_cache None without a cache."""
    B, S, _ = x.shape
    H, nope, rdim, vdim = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cq = _rms(x @ params["wdq"].to(x.dtype), params["q_norm"])
    q = heads_whole("head_split", torch.einsum("bsr,rhk->bshk", cq, params["wuq"].to(x.dtype)), H)
    q_nope, q_rope = q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)
    ckv = _rms(x @ params["wdkv"].to(x.dtype), params["kv_norm"])  # (B, S, dc)
    krope = rope((x @ params["wkr"].to(x.dtype))[:, :, None, :], positions, cfg.rope_theta)

    if cache is None:
        ckv_all, krope_all = ckv, krope
        mask = causal_mask(S, S, device=x.device)
        new_cache = None
    elif cache["pos"].ndim == 1:
        if S != 1:
            raise NotImplementedError(
                "multi-token steps with per-slot positions: the reference has no such path "
                "(ROADMAP.md Queue A, not ported by design)"
            )
        # per-slot positions (continuous batching): a row whose pos has run
        # past the cache writes nothing, as the reference's scatter drops it
        pos, CKV, KR = cache["pos"], cache["ckv"], cache["krope"]
        T = CKV.shape[1]
        rows = torch.arange(B, device=CKV.device)
        idx = pos.clamp(max=T - 1).long()
        live = pos < T
        CKV[rows, idx] = torch.where(live[:, None], ckv[:, 0].to(CKV.dtype), CKV[rows, idx])
        KR[rows, idx] = torch.where(live[:, None, None], krope[:, 0].to(KR.dtype), KR[rows, idx])
        new_cache = {"ckv": CKV, "krope": KR, "pos": pos + 1}
        ckv_all, krope_all = CKV.to(x.dtype), KR.to(x.dtype)
        mask = (torch.arange(T, device=CKV.device)[None, :] <= pos[:, None])[:, None, None, :]
    else:
        pos = cache["pos"]
        p = int(pos)
        CKV, KR = cache["ckv"], cache["krope"]
        if p + S > CKV.shape[1]:
            raise ValueError(f"cache of {CKV.shape[1]} positions cannot take {S} more at {p}")
        CKV[:, p:p + S] = ckv.to(CKV.dtype)
        KR[:, p:p + S] = krope.to(KR.dtype)
        if cfg.decode_seq_shard:
            CKV = constrain(CKV, "batch", "model", None)
            KR = constrain(KR, "batch", "model", None, None)
        new_cache = {"ckv": CKV, "krope": KR, "pos": pos + S}
        ckv_all, krope_all = CKV[:, :p + S].to(x.dtype), KR[:, :p + S].to(x.dtype)
        mask = causal_mask(S, p + S, p, device=CKV.device)

    k_nope = heads_whole("head_split",
                         torch.einsum("btc,chk->bthk", ckv_all, params["wuk"].to(x.dtype)), H)
    vmat = heads_whole("head_split",
                       torch.einsum("btc,chk->bthk", ckv_all, params["wuv"].to(x.dtype)), H)
    # redistribution point "attention_blocks" (``_sdpa``'s; MLA's keys have
    # no KV heads to repeat)
    out = local_blocks("attention_blocks", _mla_core, q_nope,
                       (q_rope, k_nope, krope_all[:, :, 0], vmat, mask, float(np.sqrt(nope + rdim))),
                       (2, 2, 2, None, 2, None if mask.ndim == 4 else WHOLE, None))
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype)), new_cache


def _mla_core(q_nope, q_rope, k_nope, krope, vmat, mask, scale: float):
    """MLA's attention over the latent keys: (B, S, H, v)."""
    # the two score products added in the activation dtype, then in f32
    scores = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshk,btk->bhst", q_rope, krope)).float()
    scores = scores / scale
    scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1).to(q_nope.dtype)
    return torch.einsum("bhst,bthk->bshk", w, vmat)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                   dtype=torch.bfloat16, device=None) -> Params:
    """Stacked-over-layers latent cache (zeros) with a scalar host-side ``pos``."""
    return {
        "ckv": torch.zeros((n_layers, batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((n_layers, batch, max_len, 1, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
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
    gate = x @ params["wi_gate"].to(x.dtype)
    up = x @ params["wi_up"].to(x.dtype)
    a = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return (a * up) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture-of-Experts with capacity-based scatter dispatch
# ---------------------------------------------------------------------------


def n_experts_padded(cfg: ModelConfig) -> int:
    """Experts held (``moe_pad_experts`` pads them; padded ones are never routed)."""
    return max(cfg.n_experts, cfg.moe_pad_experts)


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Params:
    """The router (d, E) and the expert stacks (E, d, f), (E, f, d). Each
    expert is drawn in float32 and written into a stack of ``dtype``, so a
    serving model's build holds one expert's float32 draw at a time."""
    d, f, E = cfg.d_model, cfg.d_ff, n_experts_padded(cfg)
    p = {"router": dense_init(generator, d, (E,))}
    for name, shape in (("wi_gate", (d, f)), ("wi_up", (d, f)), ("wo", (f, d))):
        stack = torch.empty((E,) + shape, dtype=dtype, device=generator.device)
        for e in range(E):
            stack[e] = dense_init(generator, shape[0], shape[1:])
        p[name] = stack
    return p


class DropCounter:
    """(token, slot) pairs routed and dropped at capacity, by kind of call
    ("prefill": S > 1, "decode": S = 1), summed on the device; a model
    counts while its ``drop_counter`` is set."""

    def __init__(self):
        self.pairs: dict[str, int] = {}
        self.dropped: dict[str, torch.Tensor] = {}

    def add(self, kind: str, pairs: int, dropped: torch.Tensor) -> None:
        self.pairs[kind] = self.pairs.get(kind, 0) + pairs
        self.dropped[kind] = self.dropped.get(kind, 0) + dropped

    def shares(self) -> dict:
        """{kind: {"pairs", "dropped", "share"}} (reads the device)."""
        out = {}
        for kind, n in self.pairs.items():
            dropped = int(self.dropped[kind])
            out[kind] = {"pairs": n, "dropped": dropped, "share": dropped / n}
        return out


def _route(params: Params, xt: torch.Tensor, cfg: ModelConfig):
    """(probs (T, E) f32, top_e (T, K), top_p (T, K) renormalised) of the
    tokens xt (T, D): router logits in the activation dtype, then f32."""
    E_real, E = cfg.n_experts, n_experts_padded(cfg)
    logits = (xt @ params["router"].to(xt.dtype)).float()
    if E > E_real:  # padded experts are never routed
        logits = logits.masked_fill(torch.arange(E, device=xt.device) >= E_real, -1e30)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert index (jax.lax.top_k's order)
    top_e = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :cfg.top_k]
    top_p = probs.gather(-1, top_e)
    return probs, top_e, top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, act: str,
              drops: DropCounter | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts with static capacity; returns (out, aux_loss).

    The (token, slot) pairs are scatter-added into per-expert (E, C, D)
    buffers, C = ceil(K·T / E_real · capacity_factor) for the T = B·S tokens
    of this call, in flat (T·K) order (pairs past C are dropped); batched
    expert products; the rows gathered back weighted by the renormalised
    router probabilities. The aux loss is Switch-style over the real
    experts. ``drops`` counts the pairs dropped."""
    B, S, D = x.shape
    E_real, K = cfg.n_experts, cfg.top_k
    E = n_experts_padded(cfg)
    T = B * S
    xt = x.reshape(T, D)
    probs, top_e, top_p = _route(params, xt, cfg)

    C = int(np.ceil(K * T / E_real * cfg.capacity_factor))
    flat_e = top_e.reshape(-1)  # (T·K,)
    onehot = F.one_hot(flat_e, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot  # exclusive cumsum
    flat_pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = flat_pos < C
    if drops is not None:
        drops.add("prefill" if S > 1 else "decode", T * K, (~keep).sum())

    tok_idx = torch.arange(T, device=x.device).repeat_interleave(K)
    safe_pos = torch.where(keep, flat_pos, C - 1)
    contrib = torch.where(keep[:, None], xt[tok_idx], 0.0)
    buf = x.new_zeros((E, C, D)).index_put((flat_e, safe_pos), contrib, accumulate=True)

    gate = torch.bmm(buf, params["wi_gate"].to(x.dtype))
    h = (F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh"))
    h = h * torch.bmm(buf, params["wi_up"].to(x.dtype))
    y_e = torch.bmm(h, params["wo"].to(x.dtype))

    y_tok = y_e[flat_e, safe_pos]  # (T·K, D)
    w = (top_p.reshape(-1) * keep).to(x.dtype)
    y = (y_tok * w[:, None]).reshape(T, K, D).sum(1)

    frac_tokens = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = E_real * torch.sum(frac_tokens * probs.mean(0))
    # redistribution point "token_rows": T tokens split over more ranks than
    # the batch has rows (a microbatch of fewer rows than the data axis)
    return split_first("token_rows", y, (B, S)), aux


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def init_embeddings(generator: torch.Generator, cfg: ModelConfig) -> Params:
    p = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(generator, cfg.vocab_size, cfg.d_model)
    return p


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    # a sharded run looks up each rank's token rows in the whole table
    # (redistribution point "embed_table"); pinned to plain batch sharding
    # when a launcher enables the constraints
    x = embed_lookup("embed_table", params["embed"].to(dtype), tokens)
    x = constrain(x, "batch", None, None)
    if cfg.scale_embeddings:
        x = x * float(np.sqrt(cfg.d_model))
    return x


def logits_from_hidden(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = params["unembed"] if "unembed" in params else params["embed"]
    return x @ table.to(x.dtype).T


def softmax_xent_weighted(logits: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Per-example-weighted token CE: logits (B, S, V), labels (B, S), weights (B,)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    w = weights[:, None].float()
    return torch.sum((lse - gold) * w) / (torch.sum(w) * labels.shape[1])


def chunked_xent_weighted(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """CE without materializing (B, S, V): a loop over sequence chunks, the
    chunk count the least divisor of S with S/n ≤ ``chunk`` (the
    reference's rule); the chunks' sums are added in order in f32."""
    B, S, D = x.shape
    n_chunks = max(-(-S // chunk), 1)
    while S % n_chunks != 0:
        n_chunks += 1
    c = S // n_chunks
    # the table gathered over the rows' mesh dims (FSDP, "fsdp_gather"): else
    # DTensor meets its data-split embed dim with the rows' split by
    # gathering the activations
    table = fsdp_gather("fsdp_gather", {"t": table.to(x.dtype)}, x)["t"]
    w = weights[:, None].float()
    labels = labels.long()
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(n_chunks):
        logits = (x[:, i * c:(i + 1) * c] @ table.T).float()
        lse = torch.logsumexp(logits, -1)
        # redistribution point "xent_gold": DTensor's gather of the gold
        # logit from vocab-sharded logits builds a masked partial that fails
        # to reduce; a sharded run takes it by a one-hot sum
        gold = take_last("xent_gold", logits, labels[:, i * c:(i + 1) * c, None])
        total = total + torch.sum((lse - gold) * w)
    return total / (torch.sum(weights).float() * S)
