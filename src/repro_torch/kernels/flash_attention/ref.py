"""Plain PyTorch version of the flash-attention kernel: dense masked softmax
attention in f32 (``repro/kernels/flash_attention/ref.py::attention_ref``)
with the GQA head mapping, on the (B, S, H, d) layout."""
from __future__ import annotations

import torch

BF16_U = 2.0 ** -8  # unit roundoff of bf16 (8 significant bits)


def _weights(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 softmax weights (B, KV, H/KV, S, S), scale d**-0.5."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, d)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * d ** -0.5
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    return torch.softmax(s, dim=-1)


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q (B, S, H, d), k/v (B, S, KV, d), H % KV == 0 → (B, S, H, d) in q's
    dtype; scores and softmax weights in f32, scale d**-0.5."""
    w = _weights(q, k, causal)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(q.shape).to(q.dtype)


def bf16_error_bound(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 output o on these (bf16) inputs and a per-element bound on
    how far the kernel's bf16 output may lie from it:

        BF16_U·|o| + 4·BF16_U·sqrt(Σ_j w_j² v_j²) + 1e-4.

    The first term is the rounding of o to bf16. The second is the softmax
    weights w rounded to bf16 for the tensor-core PV product, each by at
    most BF16_U of itself: the error Σ_j w_j δ_j v_j is at most
    BF16_U·√n·sqrt(Σ w² v²) over n keys, so the factor 4 covers every row
    of up to 16 keys, and ~7 standard deviations of the sum of independent
    roundings beyond. 1e-4 covers the f32 arithmetic."""
    w = _weights(q, k, causal)
    vf = v.float()
    o = torch.einsum("bkgst,btkd->bskgd", w, vf).reshape(q.shape)
    spread = torch.einsum("bkgst,btkd->bskgd", w.square(), vf.square()).sqrt().reshape(q.shape)
    return o, BF16_U * o.abs() + 4 * BF16_U * spread + 1e-4
