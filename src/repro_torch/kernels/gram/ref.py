"""Plain PyTorch version of the Gram kernel."""
from __future__ import annotations

import torch


def gram_ref(
    X: torch.Tensor, sw: torch.Tensor | None = None, *, acc: torch.Tensor | None = None
) -> torch.Tensor:
    """acc + (√w·X)ᵀ(√w·X); ``sw`` None means unit weights, ``acc`` None
    zeros. The chunk's Gram is formed first and acc added last."""
    Xw = X if sw is None else X * sw[:, None]
    G = Xw.T @ Xw
    return G if acc is None else acc + G
