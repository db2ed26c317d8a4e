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
``generator``. ``evaluate_coreset`` builds, refits and scores a coreset
against the full-data fit with the paper's §E.1.3 metrics.
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
from repro_torch.device import resolve_device

__all__ = [
    "CoresetResult",
    "CoresetEvaluation",
    "build_coreset",
    "evaluate_coreset",
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
    sweep_ckpt=None,
    resume: bool = False,
    device=None,
) -> CoresetResult:
    """Paper Algorithm 1 (and its baselines): indices + weights.

    Random plans, each drawn from ``generator`` in this order when not
    given: the CountSketch ``plan`` (sketch_size > 0), the hull net's
    ``hull_normals``, the sample ``draw`` (for ``uniform``: the k ids).
    ``sweep_ckpt`` / ``resume``: the scoring sweep's checkpoints
    (``ScoringEngine.score``); a resumed build draws what the uninterrupted
    one draws."""
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
        sweep_ckpt=sweep_ckpt, resume=resume,
    )
    return coreset_from_scoring(res, n, k, method, alpha, t0, generator=generator, draw=draw)


# ---------------------------------------------------------------------------
# End-to-end evaluation harness (paper's metrics: §E.1.3 Main Workflow)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CoresetEvaluation:
    method: str
    k: int
    param_l2: float          # ||ϑ_cs − ϑ_full||₂ (paper "Param. ℓ2 dist.")
    lambda_err: float        # ||λ_cs − λ_full||₂ (paper "λ error")
    likelihood_ratio: float  # NLL_full(θ_cs)/NLL_full(θ_full), ≥ ~1, →1 better
    fit_seconds: float
    sample_seconds: float


def evaluate_coreset(
    cfg: M.MCTMConfig,
    scaler: DataScaler,
    Y,
    full_fit: M.FitResult,
    k: int,
    method: str,
    *,
    generator: torch.Generator | None = None,
    build_plans: dict | None = None,
    init=None,
    steps: int = 1200,
    lr: float = 5e-2,
    alpha: float = 0.8,
    device=None,
) -> CoresetEvaluation:
    """Build a coreset, refit on it, and score the refit against
    ``full_fit`` on all of Y.

    The reference splits one key into a build key and a fit key; here the
    build's plans (``build_plans``: any of ``plan``, ``hull_normals``,
    ``draw`` of ``build_coreset``) and the fit's start (``init``) are
    inputs, and what is not given is drawn from ``generator`` — the build's
    plans first, in ``build_coreset``'s order, then ``init``. The full-data
    NLLs take the strict η = 1e-9 (the fit keeps the paper's η): the
    reported likelihood exposes any log-term blow-up the coreset failed to
    guard against."""
    from repro_torch.core.bernstein import monotone_theta
    from repro_torch.core.mctm_fit import likelihood_ratio, streamed_nll

    dev = resolve_device(device)
    Y = np.asarray(Y, np.float32)
    cs = build_coreset(cfg, scaler, Y, k, method, generator=generator, alpha=alpha,
                       device=dev, **(build_plans or {}))
    t0 = time.perf_counter()
    fit = M.fit_mctm(cfg, scaler, Y[cs.indices], weights=np.asarray(cs.weights, np.float32),
                     generator=generator, init=init, steps=steps, lr=lr, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    nll_cs = streamed_nll(cfg, scaler, fit.params, Y, eta=1e-9, device=dev)
    nll_full = streamed_nll(cfg, scaler, full_fit.params, Y, eta=1e-9, device=dev)
    with torch.no_grad():
        th_cs = monotone_theta(fit.params.theta_raw, cfg.min_slope)
        th_full = monotone_theta(full_fit.params.theta_raw.to(dev), cfg.min_slope)
        param_l2 = float(torch.linalg.norm(th_cs - th_full))
        lam_err = float(torch.linalg.norm(fit.params.lam - full_fit.params.lam.to(dev)))
    return CoresetEvaluation(
        method=method, k=cs.size, param_l2=param_l2, lambda_err=lam_err,
        likelihood_ratio=likelihood_ratio(nll_cs, nll_full), fit_seconds=fit_s,
        sample_seconds=cs.seconds,
    )
