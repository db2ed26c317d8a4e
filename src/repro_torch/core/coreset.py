"""Hybrid coreset construction for MCTMs — the paper's Algorithm 1, ported
from ``repro.core.coreset``.

  1. score all n points (``ScoringEngine``: leverage of the flattened basis
     plus the directional hull extremes of the derivative rows);
  2. s_i = u_i + 1/n → probabilities p_i;
  3. sample k1 = ⌊α·k⌋ points with replacement, weights 1/(k1·p_i);
  4. add k2 = k − k1 extremal points (weight 1), topped up to exactly k2.

The baselines ``uniform``, ``l2-only``, ``ridge-lss`` and ``root-l2`` share
the entry point via ``method=``. The sample draw is an input (``draw=``)
where a caller needs the reference's draws; otherwise it comes from
``generator``. ``evaluate_coreset`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import mctm as M
from repro_torch.core.bernstein import DataScaler
from repro_torch.core.hull import stable_first_unique
from repro_torch.core.scoring import DEFAULT_CHUNK, ScoringEngine

__all__ = [
    "CoresetResult",
    "build_coreset",
    "coreset_scores",
    "coreset_from_scoring",
    "exact_hull_points",
    "CORESET_METHODS",
]

CORESET_METHODS: tuple[str, ...] = ("uniform", "l2-only", "l2-hull", "ridge-lss", "root-l2")


@dataclasses.dataclass
class CoresetResult:
    indices: np.ndarray        # (k,) point indices into the full dataset
    weights: np.ndarray        # (k,) positive weights
    scores: np.ndarray | None  # (n,) sampling scores used (None for uniform)
    method: str
    seconds: float

    @property
    def size(self) -> int:
        return int(self.indices.shape[0])


def coreset_scores(
    cfg: M.MCTMConfig,
    scaler: DataScaler,
    Y,
    method: str = "l2-hull",
    *,
    sketch_size: int = 0,
    generator: torch.Generator | None = None,
    plan=None,
    ridge_reg: float = 1.0,
    chunk_size: int | None = DEFAULT_CHUNK,
    device=None,
) -> np.ndarray:
    """Per-point sampling scores s_i for each method."""
    n = np.asarray(Y).shape[0]
    if method == "uniform":
        return np.full(n, 1.0 / n)
    if method not in CORESET_METHODS:
        raise ValueError(f"unknown coreset method: {method}")
    engine = ScoringEngine(cfg, scaler, chunk_size=chunk_size, device=device)
    res = engine.score(
        Y, method=method, generator=generator, plan=plan, sketch_size=sketch_size,
        ridge_reg=ridge_reg,
    )
    return res.scores


def exact_hull_points(res, scores: np.ndarray, k_hull: int) -> np.ndarray:
    """Exactly ``k_hull`` distinct point ids from the hull candidates, in
    first-occurrence order, topped up from the next-ranked points by score."""
    r = res.rows_per_point
    pts = (
        stable_first_unique(np.asarray(res.hull_rows) // r, k_hull)
        if res.hull_rows is not None
        else np.zeros(0, np.int64)
    )
    short = k_hull - pts.shape[0]
    if short > 0:
        chosen = set(pts.tolist())
        ranked = np.argsort(-scores, kind="stable")
        extra = np.fromiter((i for i in ranked if i not in chosen), dtype=np.int64, count=short)
        pts = np.concatenate([pts, extra])
    return pts


def coreset_from_scoring(
    res,
    n: int,
    k: int,
    method: str,
    alpha: float,
    t0: float,
    *,
    generator: torch.Generator | None = None,
    draw=None,
) -> CoresetResult:
    """Sampling + hull-union step of Algorithm 1 from a ``ScoringResult``.

    ``draw`` (k1,) are the sampled point ids (the reference's
    ``jax.random.choice`` draw in parity tests); otherwise k1 ids are drawn
    with replacement ∝ p from ``generator``."""
    k_sample = int(np.floor(alpha * k)) if method == "l2-hull" else k
    k_hull = k - k_sample if method == "l2-hull" else 0
    scores = res.scores
    probs = scores / scores.sum()
    if draw is not None:
        idx = np.asarray(draw, np.int64)
        if idx.shape != (k_sample,) or idx.min() < 0 or idx.max() >= n:
            raise ValueError(f"draw must be ({k_sample},) ids in [0, {n})")
    else:
        if generator is None:
            raise ValueError("coreset sampling requires generator or draw")
        idx = torch.multinomial(
            torch.as_tensor(probs, dtype=torch.float64), k_sample, replacement=True,
            generator=generator,
        ).numpy()
    w = 1.0 / (k_sample * probs[idx])
    if method == "l2-hull" and k_hull > 0:
        hull_pts = exact_hull_points(res, scores, k_hull)
        idx = np.concatenate([idx, hull_pts])
        w = np.concatenate([w, np.ones(k_hull)])
    return CoresetResult(idx, w, scores, method, time.perf_counter() - t0)


def build_coreset(
    cfg: M.MCTMConfig,
    scaler: DataScaler,
    Y,
    k: int,
    method: str = "l2-hull",
    *,
    generator: torch.Generator | None = None,
    alpha: float = 0.8,
    sketch_size: int = 0,
    chunk_size: int | None = DEFAULT_CHUNK,
    plan=None,
    hull_normals=None,
    hull_dirs=None,
    draw=None,
    device=None,
) -> CoresetResult:
    """Paper Algorithm 1 (and its baselines): indices + weights.

    Random plans, each drawn from ``generator`` in this order when not
    given: the CountSketch ``plan`` (sketch_size > 0), the hull net's
    ``hull_normals``, the sample ``draw`` (for ``uniform``: the k ids)."""
    t0 = time.perf_counter()
    Y = np.asarray(Y)
    n = Y.shape[0]
    k = min(k, n)
    k_hull = k - int(np.floor(alpha * k)) if method == "l2-hull" else 0

    if method == "uniform":
        if draw is None:
            if generator is None:
                raise ValueError("uniform sampling requires generator or draw")
            draw = torch.randperm(n, generator=generator)[:k].numpy()
        idx = np.asarray(draw, np.int64)
        w = np.full(k, n / k)
        return CoresetResult(idx, w, None, method, time.perf_counter() - t0)

    engine = ScoringEngine(cfg, scaler, chunk_size=chunk_size, device=device)
    res = engine.score(
        Y, method=method, generator=generator, plan=plan, sketch_size=sketch_size,
        hull_k=k_hull, hull_normals=hull_normals, hull_dirs=hull_dirs,
    )
    return coreset_from_scoring(res, n, k, method, alpha, t0, generator=generator, draw=draw)
