"""RG-LRU recurrent block (Griffin / RecurrentGemma), ``repro/models/rglru.py``.

The recurrent block runs a Real-Gated Linear Recurrent Unit:

    r_t = σ(W_a x_t + b_a)           (recurrence gate)
    i_t = σ(W_x x_t + b_x)           (input gate)
    a_t = exp(−c · r_t · softplus(Λ))  ∈ (0,1)         (c = 8)
    h_t = a_t h_{t-1} + √(1−a_t²) · (i_t ⊙ x_t)

The reference has no Pallas kernel for it: its prefill is
``jax.lax.associative_scan`` in XLA, and so the port's is plain PyTorch
(:func:`associative_scan`, the same odd/even recursion, about 2·log₂T
levels of elementwise ops rather than T steps); decode is one step. The
gates and the decay are computed in float32, the scan carried in
``cfg.scan_dtype``. The cache's conv tail is bfloat16 whatever the model's
dtype, as the reference's; caches are written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

Params = dict
RGLRU_C = 8.0


def init_rglru_block(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Full Griffin recurrent block: gate branch ⊗ (conv → RG-LRU) branch,
    float32 on the generator's device (the draws differ from ``jax.random``'s)."""
    W, dev = cfg.lru_width, generator.device
    # Λ so that a ∈ (0.9, 0.999) at r = 1 (Griffin appendix)
    u = torch.empty((W,), device=dev).uniform_(0.9 ** 2, 0.999 ** 2, generator=generator)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))  # softplus⁻¹(−log u / c)
    conv_w = torch.empty((cfg.conv_kernel, W), device=dev).normal_(generator=generator)
    return {
        "gate_proj": dense_init(generator, cfg.d_model, (W,)),
        "rec_proj": dense_init(generator, cfg.d_model, (W,)),
        "conv_w": 0.1 * conv_w,
        "conv_b": torch.zeros((W,), device=dev),
        "wa": dense_init(generator, W, (W,)),
        "ba": torch.zeros((W,), device=dev),
        "wx": dense_init(generator, W, (W,)),
        "bx": torch.zeros((W,), device=dev),
        "lam": lam,
        "out_proj": dense_init(generator, W, (cfg.d_model,)),
    }


def _combine(c1, c2):
    """h_t = a_t h_{t-1} + b_t composed: the earlier (a1, b1), then (a2, b2)."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along dim 1: even[0], odd[0], even[1], ... (even may hold one more)."""
    if even.shape[1] == odd.shape[1]:
        return torch.stack([even, odd], 2).flatten(1, 2)
    head = torch.stack([even[:, :-1], odd], 2).flatten(1, 2)
    return torch.cat([head, even[:, -1:]], 1)


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan of ``_combine`` over (a, b) along dim 1, by the
    algorithm of ``jax.lax.associative_scan``: combine adjacent pairs, scan
    the pairs recursively, then combine each odd prefix with the next even
    element, so the products are taken in the reference's order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea, eb = torch.cat([a[:, :1], ea], 1), torch.cat([b[:, :1], eb], 1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _gates(xw: torch.Tensor, params: Params):
    """(a, β·i) in float32 from the post-conv inputs: the decay and the input
    weight of each step."""
    dt = xw.dtype
    r = torch.sigmoid((xw @ params["wa"].to(dt) + params["ba"].to(dt)).float())
    i = torch.sigmoid((xw @ params["wx"].to(dt) + params["bx"].to(dt)).float())
    softplus = torch.logaddexp(params["lam"].float(), torch.zeros((), device=xw.device))
    log_a = -RGLRU_C * r * softplus  # ≤ 0
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return torch.exp(log_a), beta * i


def _rglru_scan(xw: torch.Tensor, params: Params, h0: torch.Tensor,
                scan_dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """xw: (B, T, W) post-conv inputs. Returns (y (B, T, W) in xw's dtype,
    h_T (B, W) float32); the scan's carry is ``scan_dtype``."""
    a, bi = _gates(xw, params)
    b = bi * xw.float()
    # h0 as a pseudo-step: h_t = a_t h_{t-1} + b_t with h_0 given
    a_all = torch.cat([torch.ones_like(a[:, :1]), a], 1).to(scan_dtype)
    b_all = torch.cat([h0.float()[:, None], b], 1).to(scan_dtype)
    _, h = associative_scan(a_all, b_all)
    h = h[:, 1:]
    return h.to(xw.dtype), h[:, -1].float()


def rglru_block_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      cache: Params | None = None) -> tuple[torch.Tensor, Params | None]:
    """Returns (out, new_cache); cache = {"conv" (B, k−1, W), "h" (B, W), "pos"},
    updated in place (new_cache holds the same buffers), None without one."""
    B, T, _ = x.shape
    dt = x.dtype
    gate = F.gelu(x @ params["gate_proj"].to(dt), approximate="tanh")
    xr = x @ params["rec_proj"].to(dt)

    # causal depthwise conv with the history tail
    k = params["conv_w"].shape[0]
    tail = cache["conv"].to(dt) if cache is not None else x.new_zeros((B, k - 1, xr.shape[-1]))
    xp = torch.cat([tail, xr], 1)
    xw = sum(xp[:, i:i + T] * params["conv_w"][i].to(dt) for i in range(k))
    xw = xw + params["conv_b"].to(dt)
    new_tail = xp[:, -(k - 1):] if k > 1 else tail

    h0 = cache["h"] if cache is not None else x.new_zeros((B, xr.shape[-1]), dtype=torch.float32)
    if T == 1 and cache is not None:
        a, bi = _gates(xw[:, 0], params)
        h = a * h0.float() + bi * xw[:, 0].float()
        y, hT = h[:, None].to(dt), h
    else:
        y, hT = _rglru_scan(xw, params, h0, scan_dtype=getattr(torch, cfg.scan_dtype))

    out = (y * gate) @ params["out_proj"].to(dt)
    if cache is None:
        return out, None
    cache["conv"].copy_(new_tail)
    cache["h"].copy_(hT)
    return out, {"conv": cache["conv"], "h": cache["h"], "pos": cache["pos"] + T}


def init_rglru_cache(cfg: ModelConfig, batch: int, n_layers: int, device=None) -> Params:
    """Stacked-over-layers state (zeros): the conv tail in bfloat16, h in
    float32, a scalar host-side ``pos``."""
    W = cfg.lru_width
    return {
        "conv": torch.zeros((n_layers, batch, cfg.conv_kernel - 1, W), dtype=torch.bfloat16,
                            device=device),
        "h": torch.zeros((n_layers, batch, W), dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32),
    }
