"""Multivariate Conditional Transformation Models — the port of
``repro.core.mctm``.

Model: Z = Λ h̃(Y) ~ N(0, I) with Λ unit lower triangular and h̃_j(y) =
a_j(y)ᵀ ϑ_j a monotone Bernstein expansion. Per-point negative log-likelihood
(paper Eq. 1, plus the Gaussian constant):

    Σ_j ½ (Σ_{l<j} λ_{jl} h̃_l(y_il) + h̃_j(y_ij))² − log h̃'_j(y_ij) + J/2 log(2π)

The parameters are an ``nn.Module`` holding ``theta_raw (J, d)`` and
``lam (J(J-1)/2,)``; everything else is plain functions on tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.bernstein import DataScaler, monotone_theta, monotone_theta_inverse
from repro_torch.device import resolve_device, to_tensor
from repro_torch.kernels.bernstein import bernstein_featurize

LOG_2PI = float(np.log(2.0 * np.pi))


@dataclasses.dataclass(frozen=True)
class MCTMConfig:
    """Static model configuration."""

    J: int                   # output dimension
    degree: int = 6          # Bernstein degree M; d = degree + 1 coefficients
    eta: float = 1e-3        # D(η) floor for the log-Jacobian term (paper: η = 2ε)
    min_slope: float = 1e-4  # strict-monotonicity margin of ϑ

    @property
    def d(self) -> int:
        return self.degree + 1

    @property
    def n_params(self) -> int:
        return self.J * self.d + self.J * (self.J - 1) // 2


class MCTMParams(nn.Module):
    """Unconstrained parameters: ϑ via cumulative softplus, λ strict-lower."""

    def __init__(self, theta_raw: torch.Tensor, lam: torch.Tensor):
        super().__init__()
        self.theta_raw = nn.Parameter(theta_raw)
        self.lam = nn.Parameter(lam)


def init_params(
    cfg: MCTMConfig,
    *,
    generator: torch.Generator | None = None,
    normals=None,
    dtype=torch.float32,
    device=None,
) -> MCTMParams:
    """Near-identity start h̃(y) ≈ 4t − 2 plus 0.01·N(0, 1) jitter on ϑ.

    ``normals`` (J, d) supplies the jitter draws (the reference's
    ``jax.random.normal`` draws, in parity tests); otherwise they come from
    ``generator`` (a CPU ``torch.Generator``)."""
    dev = resolve_device(device)
    base = torch.linspace(-2.0, 2.0, cfg.d, dtype=dtype)
    theta_raw = monotone_theta_inverse(base, cfg.min_slope).repeat(cfg.J, 1)
    if normals is None:
        normals = torch.randn((cfg.J, cfg.d), generator=generator, dtype=dtype)
    theta_raw = theta_raw + 0.01 * to_tensor(normals, dtype)
    lam = torch.zeros((cfg.J * (cfg.J - 1) // 2,), dtype=dtype)
    return MCTMParams(theta_raw.to(dev), lam.to(dev))


def params_from_numpy(theta_raw, lam, *, dtype=torch.float32, device=None) -> MCTMParams:
    """The reference's ``MCTMParams`` leaves, as numpy arrays → the port's."""
    dev = resolve_device(device)
    return MCTMParams(
        to_tensor(theta_raw, dtype, dev).clone(),
        to_tensor(lam, dtype, dev).clone(),
    )


def params_to_numpy(params: MCTMParams) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of ``params_from_numpy``: (theta_raw, lam) numpy arrays."""
    return (
        params.theta_raw.detach().cpu().numpy().copy(),
        params.lam.detach().cpu().numpy().copy(),
    )


def lambda_matrix(cfg: MCTMConfig, lam_flat: torch.Tensor) -> torch.Tensor:
    """Unit lower-triangular Λ from the flat strict-lower entries (row-major,
    as ``np.tril_indices``)."""
    J = cfg.J
    eye = torch.eye(J, dtype=lam_flat.dtype, device=lam_flat.device)
    if J == 1:
        return eye
    rows, cols = np.tril_indices(J, k=-1)
    idx = (torch.as_tensor(rows, device=lam_flat.device), torch.as_tensor(cols, device=lam_flat.device))
    return eye.index_put(idx, lam_flat)


def basis_features(
    cfg: MCTMConfig, scaler: DataScaler, Y: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, A′): a_j(y_ij) and d/dy a_j(y_ij), shapes (n, J, d) — the fused
    featurize (CUDA kernel on a CUDA tensor, plain version on the CPU)."""
    dtype = torch.promote_types(Y.dtype, torch.float32)
    Y = Y.to(dtype).contiguous()
    return bernstein_featurize(Y, scaler.bounds(dtype, Y.device), cfg.degree)


def transform_parts(cfg: MCTMConfig, params, A: torch.Tensor, Ap: torch.Tensor):
    """(z, h̃, h̃′): copula inputs and marginal transform/derivative."""
    theta = monotone_theta(params.theta_raw, cfg.min_slope)
    htilde = torch.einsum("njd,jd->nj", A, theta)
    hprime = torch.einsum("njd,jd->nj", Ap, theta)
    Lam = lambda_matrix(cfg, params.lam)
    z = htilde @ Lam.T
    return z, htilde, hprime


def nll_terms(cfg: MCTMConfig, params, A: torch.Tensor, Ap: torch.Tensor) -> torch.Tensor:
    """Per-point negative log-likelihood contributions, shape (n,)."""
    z, _, hprime = transform_parts(cfg, params, A, Ap)
    log_jac = torch.log(torch.clamp(hprime, min=cfg.eta))
    per_dim = 0.5 * torch.square(z) - log_jac + 0.5 * LOG_2PI
    return torch.sum(per_dim, dim=-1)


def nll(cfg: MCTMConfig, params, A, Ap, weights=None) -> torch.Tensor:
    """(Weighted) total negative log-likelihood — the paper's f(A, ϑ, λ)."""
    terms = nll_terms(cfg, params, A, Ap)
    return torch.sum(terms) if weights is None else torch.sum(weights * terms)


def loss_parts(cfg: MCTMConfig, params, A, Ap, weights=None) -> dict[str, torch.Tensor]:
    """f1 = ½ Σ w z²;  f2 = Σ w max(log h̃′, 0);  f3 = Σ w max(−log h̃′, 0)."""
    z, _, hprime = transform_parts(cfg, params, A, Ap)
    log_jac = torch.log(torch.clamp(hprime, min=cfg.eta))
    w = torch.ones(z.shape[0], dtype=z.dtype, device=z.device) if weights is None else weights
    w = w[:, None]
    return {
        "f1": 0.5 * torch.sum(w * torch.square(z)),
        "f2": torch.sum(w * torch.clamp(log_jac, min=0.0)),
        "f3": torch.sum(w * torch.clamp(-log_jac, min=0.0)),
    }


@dataclasses.dataclass
class FitResult:
    params: MCTMParams
    losses: np.ndarray
    final_nll: float


def fit_mctm(
    cfg: MCTMConfig,
    scaler: DataScaler,
    Y,
    weights=None,
    *,
    generator: torch.Generator | None = None,
    init: MCTMParams | None = None,
    steps: int = 1500,
    lr: float = 5e-2,
    method: str = "adam",
    chunk_size: int | None = None,
    microbatches: int | None = None,
    optimizer=None,
    device=None,
) -> FitResult:
    """Weighted maximum-likelihood fit of an MCTM (``weights`` are coreset
    weights; None → unweighted). Dispatches to
    ``mctm_fit.fit_mctm_streaming``; only ``method="adam"`` is ported."""
    from repro_torch.core import mctm_fit
    from repro_torch.core.scoring import DEFAULT_CHUNK

    if method not in mctm_fit.FIT_METHODS + ("scipy-lbfgs",):
        raise ValueError(f"unknown fit method: {method}")
    return mctm_fit.fit_mctm_streaming(
        cfg, scaler, Y, weights,
        generator=generator, init=init, steps=steps, lr=lr, optimizer=optimizer,
        method=method,
        chunk_size=DEFAULT_CHUNK if chunk_size is None else chunk_size,
        microbatches=microbatches, device=device,
    )


def log_density(cfg: MCTMConfig, params, scaler: DataScaler, Y: torch.Tensor) -> torch.Tensor:
    A, Ap = basis_features(cfg, scaler, Y)
    return -nll_terms(cfg, params, A, Ap)
