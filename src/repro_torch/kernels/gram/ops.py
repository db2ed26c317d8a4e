"""Gram wrapper: G = (√w·X)ᵀ(√w·X) on the CUDA kernel (``csrc/gram.cu``)
for a CUDA tensor, on ``ref.py`` for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.gram.ref import gram_ref

MAX_D = 64
ROWS_PER_CTA = 256
LAUNCHES = 0


def gram_matrix(
    X: torch.Tensor, sw: torch.Tensor | None = None, *, backend: str | None = None
) -> torch.Tensor:
    """X (n, D) f32, sw (n,) f32 square-root weights or None → (D, D) f32."""
    global LAUNCHES
    if _lib.resolve_backend(backend, X, "gram") == "torch":
        return gram_ref(X, sw)
    if X.dtype != torch.float32 or (sw is not None and sw.dtype != torch.float32):
        raise ValueError("the gram kernel is float32 only")
    n, D = X.shape
    if D > MAX_D:
        raise ValueError(f"the gram kernel supports D ≤ {MAX_D}, got {D}")
    if sw is not None and sw.shape != (n,):
        raise ValueError(f"sw must be ({n},), got {tuple(sw.shape)}")
    _lib.require_cuda(X, sw)
    nblk = max(1, -(-n // ROWS_PER_CTA))
    partial = torch.empty((nblk, D * (D + 1) // 2), dtype=torch.float32, device=X.device)
    G = torch.empty((D, D), dtype=torch.float32, device=X.device)
    _lib.check(
        _lib.lib().repro_gram(
            _lib.ptr(X), _lib.ptr(sw), n, D, _lib.ptr(partial), _lib.ptr(G),
            _lib.stream_ptr(X.device),
        ),
        "repro_gram",
    )
    LAUNCHES += 1
    return G
