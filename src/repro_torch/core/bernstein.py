"""Bernstein polynomial basis for MCTM marginal transformations — the port
of ``repro.core.bernstein``.

``h̃_j(y) = a_j(y)ᵀ ϑ_j`` with ``a_j`` the degree-M Bernstein basis on
[low_j, high_j]: b_{k,M}(t) = C(M,k) t^k (1-t)^{M-k}, t = (y - low)/(high - low).
``h̃`` is strictly increasing iff ϑ is, which the cumulative-softplus
reparameterization enforces. The fused CUDA featurize lives in
``repro_torch.kernels.bernstein``; these functions are its plain version.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

__all__ = [
    "binomial_coefficients",
    "bernstein_design",
    "bernstein_deriv_design",
    "DataScaler",
    "monotone_theta",
    "monotone_theta_inverse",
]


def binomial_coefficients(degree: int) -> np.ndarray:
    """C(M, k) for k = 0..M, exact in float64 (degree is small, ≤ ~30)."""
    coeffs = np.ones(degree + 1, dtype=np.float64)
    for k in range(1, degree + 1):
        coeffs[k] = coeffs[k - 1] * (degree - k + 1) / k
    return coeffs


def bernstein_design(t: torch.Tensor, degree: int) -> torch.Tensor:
    """Basis on normalized inputs (clipped to [0, 1]): ``t.shape + (M+1,)``."""
    t = torch.clamp(t, 0.0, 1.0)[..., None]
    k = torch.arange(degree + 1, dtype=t.dtype, device=t.device)
    coeff = torch.as_tensor(binomial_coefficients(degree), dtype=t.dtype, device=t.device)
    return coeff * torch.pow(t, k) * torch.pow(1.0 - t, degree - k)


def bernstein_deriv_design(t: torch.Tensor, degree: int) -> torch.Tensor:
    """d a(t)/dt via d b_{k,M}/dt = M (b_{k-1,M-1} − b_{k,M-1}), b_{-1} = b_M = 0.
    Scale by 1/(high − low) for d/dy."""
    if degree == 0:
        return torch.zeros(t.shape + (1,), dtype=t.dtype, device=t.device)
    lower = bernstein_design(t, degree - 1)
    pad = torch.zeros(lower.shape[:-1] + (1,), dtype=lower.dtype, device=lower.device)
    left = torch.cat([pad, lower], dim=-1)
    right = torch.cat([lower, pad], dim=-1)
    return degree * (left - right)


@dataclasses.dataclass(frozen=True)
class DataScaler:
    """Per-dimension affine map of raw data onto [0, 1] with a safety margin,
    shared by the full-data fit and every coreset fit."""

    low: np.ndarray   # (J,)
    high: np.ndarray  # (J,)

    @staticmethod
    def fit(Y: np.ndarray, margin: float = 0.05) -> "DataScaler":
        Y = np.asarray(Y)
        lo, hi = Y.min(axis=0), Y.max(axis=0)
        span = np.maximum(hi - lo, 1e-9)
        return DataScaler(low=lo - margin * span, high=hi + margin * span)

    def transform(self, Y: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(Y.dtype, torch.float32)
        low = torch.as_tensor(self.low, dtype=dtype, device=Y.device)
        high = torch.as_tensor(self.high, dtype=dtype, device=Y.device)
        return (Y - low) / (high - low)

    @property
    def inv_span(self) -> np.ndarray:
        return 1.0 / (self.high - self.low)

    def bounds(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """(3, J) [low; high; inv_span] in ``dtype`` — the featurize kernel's
        view of the scaler (each row cast from float64, as ``transform`` and
        ``basis_features`` cast them), made once per scaler, dtype and device
        (a featurize built per call uploads nothing after the first)."""
        from torch._subclasses.fake_tensor import is_fake

        memo = _BOUNDS.get(id(self))
        if memo is None:
            memo = _BOUNDS[id(self)] = {}
            weakref.finalize(self, _BOUNDS.pop, id(self), None)
        key = (dtype, torch.device(device) if device is not None else None)
        got = memo.get(key)
        if got is None:
            rows = np.stack([self.low, self.high, self.inv_span]).astype(np.float64)
            if dtype == torch.float32:  # rounded on the host: no float64 copy on the device
                rows = rows.astype(np.float32)
            got = torch.as_tensor(rows, device=device).to(dtype)
            if not is_fake(got):  # a traced scaler leaves no fake tensor for later calls
                memo[key] = got
        return got


# ``DataScaler.bounds`` by id of a live scaler, then (dtype, device): kept
# beside the value object, so a copied or pickled scaler carries no tensor
_BOUNDS: dict[int, dict] = {}


def monotone_theta(theta_raw: torch.Tensor, min_slope: float = 1e-4) -> torch.Tensor:
    """ϑ_0 = raw_0; ϑ_k = ϑ_{k-1} + softplus(raw_k) + min_slope.

    softplus is ``logaddexp(x, 0)`` as in the reference's ``jax.nn.softplus``
    (``torch.nn.functional.softplus`` switches to x above a threshold)."""
    first = theta_raw[..., :1]
    rest = theta_raw[..., 1:]
    steps = torch.logaddexp(rest, torch.zeros_like(rest)) + min_slope
    return torch.cat([first, first + torch.cumsum(steps, dim=-1)], dim=-1)


def monotone_theta_inverse(theta: torch.Tensor, min_slope: float = 1e-4) -> torch.Tensor:
    """Inverse of ``monotone_theta`` (for warm-starting from valid ϑ)."""
    diffs = torch.diff(theta, dim=-1) - min_slope
    diffs = torch.clamp(diffs, min=1e-6)
    return torch.cat([theta[..., :1], torch.log(torch.expm1(diffs))], dim=-1)
