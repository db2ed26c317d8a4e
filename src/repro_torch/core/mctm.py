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
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.bernstein import (
    DataScaler, bernstein_design, monotone_theta, monotone_theta_inverse,
)
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
    """Unconstrained parameters: ϑ via cumulative softplus, λ strict-lower.
    ``_fields`` names the leaves in order, as a NamedTuple's do, so the fit
    layer flattens and rebuilds this type like any parameter tuple."""

    _fields = ("theta_raw", "lam")

    def __init__(self, theta_raw: torch.Tensor, lam: torch.Tensor):
        super().__init__()
        self.theta_raw = nn.Parameter(theta_raw)
        self.lam = nn.Parameter(lam)


class ParamLeaves(NamedTuple):
    """The parameters as plain tensors (``MCTMParams``'s fields), for
    functional evaluation: every function here reads ``.theta_raw`` and
    ``.lam``, so it takes either."""

    theta_raw: torch.Tensor
    lam: torch.Tensor


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
    # built on the device (no host copy), so a CUDA graph can capture it
    rows, cols = torch.tril_indices(J, J, offset=-1, device=lam_flat.device)
    return eye.index_put((rows, cols), lam_flat)


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
    mesh=None,
    chunk_size: int | None = None,
    microbatches: int | None = None,
    batch_size: int | None = None,
    optimizer=None,
    checkpoint=None,
    ckpt_every: int = 0,
    resume: bool = False,
    device=None,
) -> FitResult:
    """Weighted maximum-likelihood fit of an MCTM (``weights`` are coreset
    weights; None → unweighted). ``method`` ``"adam"``, ``"lbfgs"`` or
    ``"minibatch"`` (``batch_size`` sampled rows a step) dispatches to
    ``mctm_fit.fit_mctm_streaming``; ``"scipy-lbfgs"`` is the dense small-n oracle kept for
    tests (scipy's L-BFGS-B on the flat float64 vector, featurizing inside
    the objective). ``mesh`` (a ``DataMesh``: each rank fits on its rows, one
    fold a step), ``checkpoint`` / ``ckpt_every`` / ``resume`` pass to the
    fit layer (``mctm_fit``); the ``scipy-lbfgs`` oracle ignores ``mesh``, as
    the reference's does."""
    from repro_torch.core import mctm_fit
    from repro_torch.core.scoring import DEFAULT_CHUNK

    if method in mctm_fit.FIT_METHODS:
        return mctm_fit.fit_mctm_streaming(
            cfg, scaler, Y, weights,
            generator=generator, init=init, steps=steps, lr=lr, optimizer=optimizer,
            method=method,
            chunk_size=DEFAULT_CHUNK if chunk_size is None else chunk_size,
            microbatches=microbatches, batch_size=batch_size, checkpoint=checkpoint,
            ckpt_every=ckpt_every, resume=resume, mesh=mesh, device=device,
        )
    if method != "scipy-lbfgs":
        raise ValueError(f"unknown fit method: {method}")
    dev = resolve_device(device)
    if init is None:
        init = init_params(cfg, generator=generator, device=dev)
    Yt = to_tensor(Y, torch.float32, dev)
    w = None if weights is None else to_tensor(weights, torch.float32, dev)
    total_w = float(Yt.shape[0]) if w is None else float(torch.sum(w))

    def loss_fn(params) -> torch.Tensor:
        # the (n, J, d) basis exists only for the duration of each evaluation
        A, Ap = basis_features(cfg, scaler, Yt)
        return nll(cfg, params, A, Ap, w) / total_w

    params, losses = _scipy_lbfgs_fit(loss_fn, init)
    with torch.no_grad():
        final = float(loss_fn(params)) * total_w
    return FitResult(params=params, losses=np.asarray(losses), final_nll=final)


def _scipy_lbfgs_fit(loss_fn, params0: MCTMParams):
    """L-BFGS-B via scipy on the flat parameter vector (theta_raw, then lam)
    — the dense small-n oracle the streaming L-BFGS (``mctm_fit``,
    ``method="lbfgs"``) is tested against. The objective and its gradient
    are evaluated in float32, the optimizer runs in float64 (``maxiter``
    500), as the reference's."""
    from scipy.optimize import minimize

    theta0, lam0 = params0.theta_raw.detach(), params0.lam.detach()
    shapes, split = (theta0.shape, lam0.shape), theta0.numel()
    dev = theta0.device
    losses = []

    def unravel(x):
        flat = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return flat[:split].reshape(shapes[0]), flat[split:].reshape(shapes[1])

    def fun(x):
        leaves = [t.requires_grad_(True) for t in unravel(x)]
        v = loss_fn(ParamLeaves(*leaves))
        g = torch.autograd.grad(v, leaves)
        v = float(v.detach())
        losses.append(v)
        return v, np.concatenate([t.reshape(-1).cpu().numpy() for t in g]).astype(np.float64)

    x0 = np.concatenate([theta0.reshape(-1).cpu().numpy(), lam0.reshape(-1).cpu().numpy()])
    res = minimize(fun, x0.astype(np.float64), jac=True, method="L-BFGS-B",
                   options={"maxiter": 500})
    return MCTMParams(*(t.clone() for t in unravel(res.x))), np.asarray(losses)


def log_density(cfg: MCTMConfig, params, scaler: DataScaler, Y: torch.Tensor) -> torch.Tensor:
    A, Ap = basis_features(cfg, scaler, Y)
    return -nll_terms(cfg, params, A, Ap)


def sample(
    cfg: MCTMConfig,
    params,
    scaler: DataScaler,
    n: int,
    *,
    normals=None,
    generator: torch.Generator | None = None,
    n_grid: int = 512,
    device=None,
) -> torch.Tensor:
    """Draw n samples (n, J) by inverting h̃ on a grid of ``n_grid`` points
    (h is triangular: solve per dimension). ``normals`` (n, J) is the
    standard-normal draw z (the reference's ``jax.random.normal`` draw in
    parity tests); without it z comes from ``generator``."""
    dev = resolve_device(device)
    if normals is None:
        normals = torch.randn((n, cfg.J), generator=generator, dtype=torch.float32)
    z = to_tensor(normals, torch.float32, dev)
    if z.shape != (n, cfg.J):
        raise ValueError(f"normals must be ({n}, {cfg.J}), got {tuple(z.shape)}")
    theta_raw = params.theta_raw.detach().to(dev, torch.float32)
    lam = params.lam.detach().to(dev, torch.float32)
    Lam = lambda_matrix(cfg, lam)
    # h̃(Y) = Λ⁻¹ z → invert each monotone marginal on the grid
    target = torch.linalg.solve_triangular(Lam, z.T, upper=False).T
    theta = monotone_theta(theta_raw, cfg.min_slope)
    t_grid = torch.linspace(0.0, 1.0, n_grid, dtype=torch.float32, device=dev)
    vals = bernstein_design(t_grid, cfg.degree) @ theta.T  # (G, J), monotone in G
    low = torch.as_tensor(np.asarray(scaler.low, np.float32), device=dev)
    high = torch.as_tensor(np.asarray(scaler.high, np.float32), device=dev)
    cols = []
    for j in range(cfg.J):
        col, tgt = vals[:, j].contiguous(), target[:, j].contiguous()
        idx = torch.clamp(torch.searchsorted(col, tgt, right=False), 1, n_grid - 1)
        v0, v1 = col[idx - 1], col[idx]
        t0, t1 = t_grid[idx - 1], t_grid[idx]
        frac = torch.clamp((tgt - v0) / torch.clamp(v1 - v0, min=1e-12), 0.0, 1.0)
        cols.append(low[j] + (t0 + frac * (t1 - t0)) * (high[j] - low[j]))
    return torch.stack(cols, dim=1)
