"""Plain PyTorch version of the flash-attention kernel: dense masked softmax
attention in f32 (``repro/kernels/flash_attention/ref.py::attention_ref``)
with the GQA head mapping, on the (B, S, H, d) layout; and a plain model of
the wgmma body's split grid (``key_tiles``, ``split_parts``,
``split_attention_ref``)."""
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


def key_tiles(S: int, kt: int, causal: bool, rows: int) -> list[int]:
    """Key tiles of kt keys that each q tile of ``rows`` rows walks (the
    kernel's ``wg_tiles``): up to the diagonal's tile when causal."""
    n_kv = -(-S // kt)
    return [min(n_kv, -(-(t + 1) * rows // kt)) if causal else n_kv
            for t in range(-(-S // rows))]


def split_parts(n: int, cap: int) -> list[tuple[int, int]]:
    """The key-tile ranges [j0, j1) of the ceil(n / cap) near-even parts
    that the kernel's ``wg_part`` cuts n key tiles into."""
    parts = -(-n // cap)
    return [(y * n // parts, (y + 1) * n // parts) for y in range(parts)]


def split_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, cap: int, kt: int,
    rows: int = 128,
) -> torch.Tensor:
    """The split grid's arithmetic in f32, part by part: each part of a q
    tile (at most ``cap`` key tiles) attends its key range alone and keeps
    its unnormalised O_p, row max m_p (−1e30 where it holds no key of the
    row, as the kernel) and row sum l_p; the parts then merge in part
    order, m = max_p m_p, w_p = e^(m_p − m), O = Σ_p w_p O_p / Σ_p w_p l_p.
    The same function as ``flash_attention_ref`` up to the order of the
    sums."""
    B, S, H, d = q.shape
    g = H // k.shape[2]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(g, dim=2) for t in (k, v))
    out = torch.empty(B, S, H, d, device=q.device)
    for t, n in enumerate(key_tiles(S, kt, causal, rows)):
        r0, r1 = t * rows, min(S, (t + 1) * rows)
        ms, ls, os_ = [], [], []
        for j0, j1 in split_parts(n, cap):
            k0, k1 = j0 * kt, min(S, j1 * kt)
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, r0:r1], kf[:, k0:k1]) * d ** -0.5
            if causal:
                keep = (torch.arange(k0, k1, device=q.device)[None, :]
                        <= torch.arange(r0, r1, device=q.device)[:, None])
                s = s.masked_fill(~keep, float("-inf"))
            m = torch.cat([s, s.new_full((*s.shape[:-1], 1), -1e30)], -1).amax(-1)
            w = torch.exp(s - m[..., None])
            ms.append(m)
            ls.append(w.sum(-1))
            os_.append(torch.einsum("bhqk,bkhd->bhqd", w, vf[:, k0:k1]))
        m = torch.stack(ms).amax(0)
        acc, total = torch.zeros_like(os_[0]), torch.zeros_like(ls[0])
        for m_p, l_p, o_p in zip(ms, ls, os_):
            w_p = torch.exp(m_p - m)
            acc = acc + w_p[..., None] * o_p
            total = total + w_p * l_p
        out[:, r0:r1] = (acc / total.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3)
    return out.to(q.dtype)
