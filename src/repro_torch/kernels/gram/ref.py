"""Plain PyTorch version of the Gram kernel."""
from __future__ import annotations

import torch


def gram_ref(X: torch.Tensor, sw: torch.Tensor | None = None) -> torch.Tensor:
    """G = (√w·X)ᵀ(√w·X); ``sw`` None means unit weights."""
    Xw = X if sw is None else X * sw[:, None]
    return Xw.T @ Xw
