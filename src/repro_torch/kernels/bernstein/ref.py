"""Plain PyTorch version of the fused featurize kernel: the math of
``repro_torch.core.mctm.basis_features`` on one chunk."""
from __future__ import annotations

import torch

from repro_torch.core.bernstein import bernstein_deriv_design, bernstein_design


def bernstein_featurize_ref(Y: torch.Tensor, bounds: torch.Tensor, degree: int):
    """Y (c, J), bounds (3, J) = [low; high; inv_span] → A, A′ (c, J, d)."""
    low, high, inv_span = bounds[0], bounds[1], bounds[2]
    T = (Y - low) / (high - low)
    A = bernstein_design(T, degree)
    Ap = bernstein_deriv_design(T, degree) * inv_span[:, None]
    return A, Ap
