"""Synthetic equity-return generator (stand-in for the paper's stock panels).

Matches the stylized facts the paper's §E.2.2 experiment exercises: heavy
tails (t marginals, ν≈4), sector-block correlation with a market factor
(Gaussian copula over a factor covariance), and per-stock volatilities —
for J = 10 or 20 "stocks" over ~10k "days".

A copy of ``repro.data.equity`` (pure numpy): the port imports nothing of the
JAX package, and importing ``repro.data`` would import JAX. The generator
must stay identical to the reference's, draw for draw.
"""
from __future__ import annotations

import numpy as np

__all__ = ["generate_equity_returns"]


def generate_equity_returns(n: int = 10_000, n_stocks: int = 10, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_sectors = max(n_stocks // 5, 1)
    sector = rng.integers(0, n_sectors, n_stocks)
    beta_mkt = rng.uniform(0.6, 1.4, n_stocks)
    beta_sec = rng.uniform(0.3, 0.8, n_stocks)
    vol = rng.uniform(0.008, 0.025, n_stocks)

    mkt = rng.standard_normal(n)
    sec = rng.standard_normal((n, n_sectors))
    idio = rng.standard_normal((n, n_stocks))
    z = (
        beta_mkt[None, :] * mkt[:, None]
        + beta_sec[None, :] * sec[:, sector]
        + idio
    )
    z /= z.std(axis=0, keepdims=True)
    # heavy tails: scale by inverse-chi (t-like, ν = 4)
    w = rng.chisquare(4, n) / 4.0
    returns = vol[None, :] * z / np.sqrt(w)[:, None]
    return returns
