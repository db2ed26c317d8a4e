"""Sensitivity-sampling framework (paper Section B, Langberg–Schulman /
Feldman et al.), ported from ``repro.core.sensitivity``.

Generic importance sampler: given per-item sensitivity upper bounds s_i ≥ ζ_i,
draw |R| items i.i.d. with p_i = s_i / S and weight u_i = S·w_i/(s_i·|R|).
The draw is an input (``draw=``, the reference's ``jax.random.choice`` draw
in parity tests); otherwise it comes from ``generator``. Probabilities and
weights are float64 numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SensitivitySample", "sensitivity_sample", "sample_size_bound"]


@dataclasses.dataclass(frozen=True)
class SensitivitySample:
    indices: np.ndarray  # (k,) sampled item ids (with replacement, as the theorem)
    weights: np.ndarray  # (k,) importance weights u_i
    probs: np.ndarray    # (n,) sampling distribution used


def sensitivity_sample(
    scores,
    k: int,
    base_weights=None,
    *,
    draw=None,
    generator: torch.Generator | None = None,
) -> SensitivitySample:
    """Draw k items w.p. ∝ scores; weights make the estimator unbiased.
    ``draw`` (k,) are the item ids; without it they are drawn with
    replacement from ``generator``."""
    scores = np.asarray(scores, dtype=np.float64)
    scores = np.clip(scores, 1e-12, None)
    if base_weights is not None:
        scores = scores * np.asarray(base_weights, dtype=np.float64)
    probs = scores / scores.sum()
    n = scores.shape[0]
    if draw is not None:
        idx = np.asarray(draw, np.int64)
        if idx.shape != (k,) or (k and (idx.min() < 0 or idx.max() >= n)):
            raise ValueError(f"draw must be ({k},) ids in [0, {n})")
    else:
        if generator is None:
            raise ValueError("sensitivity sampling requires generator or draw")
        idx = torch.multinomial(torch.as_tensor(probs), k, replacement=True,
                                generator=generator).numpy()
    w_base = np.ones_like(scores) if base_weights is None else np.asarray(base_weights, np.float64)
    weights = w_base[idx] / (probs[idx] * k)
    return SensitivitySample(indices=idx, weights=weights, probs=probs)


def sample_size_bound(
    total_sensitivity: float, vc_dim: int, eps: float, delta: float = 0.01
) -> int:
    """Theorem B.2 size: O(S/ε² (Δ log S + log 1/δ)). Returned as a concrete int."""
    S = max(total_sensitivity, 1.0)
    return int(np.ceil(S / eps**2 * (vc_dim * np.log(max(S, 2.0)) + np.log(1.0 / delta))))
