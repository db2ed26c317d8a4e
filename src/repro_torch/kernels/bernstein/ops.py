"""Featurize wrapper: scaler transform + clip + Bernstein basis + scaled
derivative of a chunk of Y, on the CUDA kernel (``csrc/bernstein.cu``) for a
CUDA tensor and on ``ref.py`` for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.bernstein.ref import bernstein_featurize_ref

MAX_DEGREE = 15
LAUNCHES = 0


def bernstein_featurize(
    Y: torch.Tensor, bounds: torch.Tensor, degree: int, *, backend: str | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Y (c, J) f32, bounds (3, J) f32 = [low; high; inv_span] → (A, A′),
    each (c, J, degree+1): a_j(y_ij) and d/dy a_j(y_ij)."""
    global LAUNCHES
    if _lib.resolve_backend(backend, Y, "bernstein") == "torch":
        return bernstein_featurize_ref(Y, bounds, degree)
    if Y.dtype != torch.float32 or bounds.dtype != torch.float32:
        raise ValueError("the bernstein kernel is float32 only")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"the bernstein kernel supports degree 0..{MAX_DEGREE}, got {degree}")
    if Y.dim() != 2 or bounds.shape != (3, Y.shape[1]):
        raise ValueError(f"expected Y (c, J) and bounds (3, J), got {tuple(Y.shape)}, {tuple(bounds.shape)}")
    _lib.require_cuda(Y, bounds)
    c, J = Y.shape
    A = torch.empty((c, J, degree + 1), dtype=torch.float32, device=Y.device)
    Ap = torch.empty_like(A)
    _lib.check(
        _lib.lib().repro_bernstein_featurize(
            _lib.ptr(Y), c, J, degree, _lib.ptr(bounds), _lib.ptr(A), _lib.ptr(Ap),
            _lib.stream_ptr(Y.device),
        ),
        "repro_bernstein_featurize",
    )
    LAUNCHES += 1
    return A, Ap
