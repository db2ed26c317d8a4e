"""The paper's 14 two-dimensional data generation processes (Section E.1.1).

A copy of ``repro.data.dgp`` (pure numpy): the port imports nothing of the
JAX package, and importing ``repro.data`` would import JAX. The generators
must stay identical to the reference's, draw for draw.

Every generator takes (rng, n) and returns an (n, 2) float array. Registry
``DGPS`` maps the paper's names; ``generate(name, n, seed)`` is the entry
point used by benchmarks and tests.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["DGPS", "generate", "DGP_NAMES"]


def _mvn(rng, n, mean, cov):
    return rng.multivariate_normal(np.asarray(mean, float), np.asarray(cov, float), size=n)


def bivariate_normal(rng: np.random.Generator, n: int, rho: float = 0.7) -> np.ndarray:
    return _mvn(rng, n, [0, 0], [[1, rho], [rho, 1]])


def nonlinear_correlation(rng, n):
    x = rng.uniform(-3, 3, n)
    y1 = x**2 + rng.normal(0, 0.5, n)
    # correlation ρ(x)=sin(x) to Y1 via conditional construction
    eps = rng.normal(0, 1, n)
    rho = np.sin(x)
    y2 = rho * (y1 - x**2) / 0.5 + np.sqrt(np.clip(1 - rho**2, 0, 1)) * eps
    return np.stack([y1, y2], axis=1)


def normal_mixture(rng, n):
    z = rng.random(n) < 0.5
    a = _mvn(rng, n, [0, 0], [[1, 0.8], [0.8, 1]])
    b = _mvn(rng, n, [3, -2], [[1.5, -0.5], [-0.5, 1.5]])
    return np.where(z[:, None], a, b)


def geometric_mixed(rng, n):
    z = rng.random(n) < 0.5
    # circular component
    r = rng.normal(2.0, 0.2, n)
    th = rng.uniform(0, 2 * np.pi, n)
    circ = np.stack([r * np.cos(th), r * np.sin(th)], axis=1)
    # cross component: two perpendicular lines
    line = rng.integers(0, 2, n)
    t = rng.uniform(-2.5, 2.5, n)
    noise = rng.normal(0, 0.1, (n, 2))
    cross = np.where(
        line[:, None].astype(bool),
        np.stack([t, np.zeros_like(t)], axis=1),
        np.stack([np.zeros_like(t), t], axis=1),
    ) + noise
    return np.where(z[:, None], circ, cross)


def skew_t(rng, n, nu: float = 4.0):
    """Azzalini-style bivariate skew-t: ξ=0, Ω=[[1,.5],[.5,1]], α=[5,−3], ν=4."""
    omega = np.array([[1, 0.5], [0.5, 1.0]])
    alpha = np.array([5.0, -3.0])
    L = np.linalg.cholesky(omega)
    # skew-normal via conditioning representation
    delta = (omega @ alpha) / np.sqrt(1 + alpha @ omega @ alpha)
    u0 = np.abs(rng.normal(0, 1, n))
    u = rng.standard_normal((n, 2)) @ L.T
    sn = delta[None, :] * u0[:, None] + np.sqrt(np.clip(1 - delta**2, 1e-9, None))[None, :] * u
    w = rng.chisquare(nu, n) / nu
    return sn / np.sqrt(w)[:, None]


def heteroscedastic(rng, n):
    x = rng.uniform(-3, 3, n)
    y1 = rng.normal(x**2, np.exp(0.5 * x))
    y2 = rng.normal(np.sin(x), np.sqrt(np.abs(x)) + 1e-3)
    return np.stack([y1, y2], axis=1)


def _clayton_copula(rng, n, theta=2.0):
    """Marshall–Olkin sampling of the Clayton copula."""
    v = rng.gamma(1.0 / theta, 1.0, n)
    e = rng.exponential(1.0, (n, 2))
    return (1.0 + e / v[:, None]) ** (-1.0 / theta)


def copula_complex(rng, n):
    from scipy import stats

    u = _clayton_copula(rng, n, theta=2.0)
    y1 = stats.gamma(2, scale=1.0).ppf(u[:, 0])
    y2 = stats.lognorm(s=1.0).ppf(u[:, 1])
    return np.stack([y1, y2], axis=1)


def spiral(rng, n):
    t = rng.uniform(0, 3 * np.pi, n)
    r = 0.5 * t
    y1 = r * np.cos(t) + rng.normal(0, 0.5, n)
    y2 = r * np.sin(t) + rng.normal(0, 0.5, n)
    return np.stack([y1, y2], axis=1)


def circular(rng, n):
    th = rng.uniform(0, 2 * np.pi, n)
    r = rng.normal(5, 1, n)
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=1)


def t_copula(rng, n, rho=0.7, nu=3.0):
    from scipy import stats

    L = np.linalg.cholesky(np.array([[1, rho], [rho, 1]]))
    g = rng.standard_normal((n, 2)) @ L.T
    w = rng.chisquare(nu, n) / nu
    t_samples = g / np.sqrt(w)[:, None]
    u = stats.t(nu).cdf(t_samples)
    y1 = stats.t(5).ppf(u[:, 0])
    y2 = stats.expon(scale=1.0).ppf(np.clip(u[:, 1], 1e-12, 1 - 1e-12))
    return np.stack([y1, y2], axis=1)


def piecewise(rng, n):
    y1 = rng.normal(0, 2, n)
    e1 = rng.normal(0, 0.5, n)
    e2 = rng.normal(0, 0.8, n)
    e3 = rng.normal(0, 0.5, n)
    y2 = np.where(
        y1 < -1, 1.5 * y1 + e1, np.where(y1 < 1, -0.5 * y1 + e2, -2.0 * y1 + e3)
    )
    return np.stack([y1, y2], axis=1)


def hourglass(rng, n):
    y1 = rng.normal(0, 2, n)
    y2 = rng.normal(0, np.sqrt(0.2 + 0.3 * y1**2))
    return np.stack([y1, y2], axis=1)


def bimodal_clusters(rng, n):
    z = rng.random(n) < 0.5
    a = _mvn(rng, n, [-2, 2], [[1, 0.8], [0.8, 1]])
    b = _mvn(rng, n, [2, 2], [[1, -0.7], [-0.7, 1]])
    return np.where(z[:, None], a, b)


def sinusoidal(rng, n):
    y1 = rng.uniform(-3, 3, n)
    y2 = 2 * np.sin(np.pi * y1) + rng.normal(0, 0.5, n)
    return np.stack([y1, y2], axis=1)


DGPS: dict[str, Callable[[np.random.Generator, int], np.ndarray]] = {
    "bivariate_normal": bivariate_normal,
    "nonlinear_correlation": nonlinear_correlation,
    "normal_mixture": normal_mixture,
    "geometric_mixed": geometric_mixed,
    "skew_t": skew_t,
    "heteroscedastic": heteroscedastic,
    "copula_complex": copula_complex,
    "spiral": spiral,
    "circular": circular,
    "t_copula": t_copula,
    "piecewise": piecewise,
    "hourglass": hourglass,
    "bimodal_clusters": bimodal_clusters,
    "sinusoidal": sinusoidal,
}

DGP_NAMES = tuple(DGPS)


def generate(name: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return DGPS[name](rng, n).astype(np.float64)
