"""Plain PyTorch version of the directional-extremes kernel."""
from __future__ import annotations

import torch


def fma_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (float32) rounded as an FMA chain over the inner index:
    s = a₀b₀, then s = fma(a_k, b_k, s). That is the rounding of the CUDA
    kernels and of the JAX package's CPU dot, so results — and argmax
    indices taken over them — agree exactly with both. Each fma is formed in
    float64 (where the product is exact) and rounded once to float32."""
    ad, bd = a.double(), b.double()
    out = (ad[:, :1] * bd[0]).float()
    for k in range(1, a.shape[1]):
        out = (ad[:, k : k + 1] * bd[k] + out.double()).float()
    return out


def direction_scores(P: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """S = dirs @ Pᵀ (m, rows), rounded as the kernels round it."""
    return fma_matmul(dirs, P.T)


def directional_extremes_ref(P: torch.Tensor, dirs: torch.Tensor, n_valid: int | None = None):
    """(vmax, imax, vmin, imin) of dirs @ Pᵀ per direction over rows
    < n_valid (rows past it score ∓inf); first occurrence on ties; int32
    row ids into P."""
    S = direction_scores(P, dirs)
    Smax = Smin = S
    if n_valid is not None and n_valid < P.shape[0]:
        valid = torch.arange(P.shape[0], device=P.device) < n_valid
        Smax = torch.where(valid, S, float("-inf"))
        Smin = torch.where(valid, S, float("inf"))
    imax = torch.argmax(Smax, dim=1)
    imin = torch.argmin(Smin, dim=1)
    vmax = torch.gather(Smax, 1, imax[:, None])[:, 0]
    vmin = torch.gather(Smin, 1, imin[:, None])[:, 0]
    return vmax, imax.to(torch.int32), vmin, imin.to(torch.int32)
