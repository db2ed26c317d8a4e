"""Gram wrapper: G = acc + (√w·X)ᵀ(√w·X) on the CUDA kernel
(``csrc/gram.cu``, one launch: the cluster body for D ≤ 64, the tiled body
up to MAX_D) for a CUDA tensor, on ``ref.py`` for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.gram.ref import gram_ref

MAX_D = _lib.CUDA_CONSTANTS["gram.cu"]["kWideMaxD"]  # J·(degree+1) to J = 20 at degree 6
LAUNCHES = 0


def gram_matrix(
    X: torch.Tensor,
    sw: torch.Tensor | None = None,
    *,
    acc: torch.Tensor | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """X (n, D) f32, sw (n,) f32 square-root weights or None, acc (D, D) f32
    or None → acc + (√w·X)ᵀ(√w·X), (D, D) f32, a new tensor. The chunk's
    sum is formed first and acc added last, so the result has the bits of
    ``acc + gram_matrix(X, sw)``."""
    global LAUNCHES
    if _lib.resolve_backend(backend, X, "gram") == "torch":
        return gram_ref(X, sw, acc=acc)
    if any(t is not None and t.dtype != torch.float32 for t in (X, sw, acc)):
        raise ValueError("the gram kernel is float32 only")
    n, D = X.shape
    if D > MAX_D:
        raise ValueError(f"the gram kernel supports D ≤ {MAX_D}, got {D}")
    if sw is not None and sw.shape != (n,):
        raise ValueError(f"sw must be ({n},), got {tuple(sw.shape)}")
    if acc is not None and acc.shape != (D, D):
        raise ValueError(f"acc must be ({D}, {D}), got {tuple(acc.shape)}")
    _lib.require_cuda(X, sw, acc)
    # the kernel copies X and sw 16 bytes at a time
    X = X if X.data_ptr() % 16 == 0 else X.clone()
    sw = sw if sw is None or sw.data_ptr() % 16 == 0 else sw.clone()
    G = torch.empty((D, D), dtype=torch.float32, device=X.device)
    _lib.check(
        _lib.lib().repro_gram(
            _lib.ptr(X), _lib.ptr(sw), n, D, _lib.ptr(acc), _lib.ptr(G),
            _lib.stream_ptr(X.device),
        ),
        "repro_gram",
    )
    LAUNCHES += 1
    return G
