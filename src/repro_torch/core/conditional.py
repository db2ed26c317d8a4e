"""Conditional MCTM extension (paper §4 'Choice of copula and basis
functions'), ported from ``repro.core.conditional``:

    h̃_j(y_j | x) = a_j(y_j)ᵀ ϑ_j + xᵀ β_j          (linear conditional shift)

The coreset extension "only increases the dimension dependence by the number
of features conditioned on": the leverage row becomes (b_i, x_i) ∈ R^{dJ+F},
and the hull stays on the derivative rows a'(y). ``conditional_coreset_scores``
streams the augmented rows through the ``ScoringEngine`` with a featurize
that emits (b_i, x_i) and the derivative rows from one bernstein launch a
chunk; inputs travel column-concatenated as rows (y_i, x_i).

Random plans are inputs, as in ``coreset.build_coreset``: the CountSketch
``plan``, the hull net's ``hull_normals`` and the sample ``draw``; what is
not given is drawn from ``generator`` in that order (the reference splits
its key as (draw, hull[, sketch]) instead).

``fit_cmctm(mesh=)`` fits data parallel over a ``DataMesh`` through the fit
layer's mesh (``core.mctm_fit``): each rank its slice of the padded (y, x)
rows, one fold a step or oracle sweep, and the final NLL's float64 totals
folded once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import mctm as M
from repro_torch.core.bernstein import DataScaler, monotone_theta
from repro_torch.core.coreset import coreset_from_scoring
from repro_torch.core.scoring import DEFAULT_CHUNK, ScoringEngine, _mctm_featurize
from repro_torch.device import resolve_device, to_tensor

__all__ = [
    "CMCTMConfig",
    "CMCTMParams",
    "CMCTMDensityModel",
    "init_cparams",
    "cparams_from_numpy",
    "cparams_to_numpy",
    "cnll_terms",
    "cnll",
    "fit_cmctm",
    "conditional_scoring_engine",
    "conditional_coreset_scores",
    "build_conditional_coreset",
]


@dataclasses.dataclass(frozen=True)
class CMCTMConfig:
    J: int
    n_features: int
    degree: int = 6
    eta: float = 1e-3
    min_slope: float = 1e-4

    @property
    def d(self) -> int:
        return self.degree + 1

    @property
    def base(self) -> M.MCTMConfig:
        return M.MCTMConfig(J=self.J, degree=self.degree, eta=self.eta, min_slope=self.min_slope)


class CMCTMParams(NamedTuple):
    theta_raw: torch.Tensor  # (J, d)
    lam: torch.Tensor        # (J(J−1)/2,)
    beta: torch.Tensor       # (J, F) conditional shift coefficients


def init_cparams(cfg: CMCTMConfig, *, generator: torch.Generator | None = None, normals=None,
                 device=None) -> CMCTMParams:
    """``mctm.init_params`` of the base model (``normals`` or ``generator``
    for its jitter) with β = 0."""
    base = M.init_params(cfg.base, generator=generator, normals=normals, device=device)
    dev = base.theta_raw.device
    beta = torch.zeros((cfg.J, cfg.n_features), dtype=torch.float32, device=dev)
    return CMCTMParams(base.theta_raw.detach().clone(), base.lam.detach().clone(), beta)


def cparams_from_numpy(theta_raw, lam, beta, *, dtype=torch.float32, device=None) -> CMCTMParams:
    """The reference's ``CMCTMParams`` leaves, as numpy arrays → the port's."""
    dev = resolve_device(device)
    return CMCTMParams(*(to_tensor(a, dtype, dev).clone() for a in (theta_raw, lam, beta)))


def cparams_to_numpy(params: CMCTMParams) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of ``cparams_from_numpy``: (theta_raw, lam, beta)."""
    return tuple(t.detach().cpu().numpy().copy() for t in params)


def _transform_parts(cfg: CMCTMConfig, params, A, Ap, X):
    theta = monotone_theta(params.theta_raw, cfg.min_slope)
    htilde = torch.einsum("njd,jd->nj", A, theta) + X @ params.beta.T
    hprime = torch.einsum("njd,jd->nj", Ap, theta)  # the shift has no y-derivative
    Lam = M.lambda_matrix(cfg.base, params.lam)
    return htilde @ Lam.T, hprime


def cnll_terms(cfg: CMCTMConfig, params, A, Ap, X) -> torch.Tensor:
    """Per-point conditional negative log-likelihood, shape (n,)."""
    z, hprime = _transform_parts(cfg, params, A, Ap, X)
    log_jac = torch.log(torch.clamp(hprime, min=cfg.eta))
    per_dim = 0.5 * torch.square(z) - log_jac + 0.5 * M.LOG_2PI
    return torch.sum(per_dim, dim=-1)


def cnll(cfg: CMCTMConfig, params, A, Ap, X, weights=None) -> torch.Tensor:
    terms = cnll_terms(cfg, params, A, Ap, X)
    return torch.sum(terms if weights is None else weights * terms)


class CMCTMDensityModel:
    """``loss_fn(params, batch)`` of the weighted conditional objective for
    the fit layer (``mctm_fit.fit_density_model``). batch is ``{"YX": (b,
    J + F), "weights"}`` — rows (y_i, x_i), the basis evaluated inside the
    loss — or ``{"A", "Ap", "X", "weights"}`` when the caller featurized
    already (the dense fast path). ``features`` returns (A, Ap, X): the
    lbfgs HVP evaluates them before its transforms."""

    feature_keys = ("A", "Ap", "X")
    leaf_type = CMCTMParams

    def __init__(self, cfg: CMCTMConfig, scaler: DataScaler, *, norm: float = 1.0):
        from repro_torch.core.mctm_fit import fit_featurize

        self.cfg = cfg
        self.scaler = scaler
        self.norm = float(norm)
        self._feat = fit_featurize(cfg.base, scaler)

    def features(self, batch):
        if "A" in batch:
            return batch["A"], batch["Ap"], batch["X"]
        YX = batch["YX"]
        A, Ap = self._feat(YX[:, : self.cfg.J])
        return A, Ap, YX[:, self.cfg.J:]

    def loss_fn(self, params, batch) -> torch.Tensor:
        terms = cnll_terms(self.cfg, params, *self.features(batch))
        w = batch.get("weights")
        return torch.sum(terms if w is None else w * terms) / self.norm


def _stack_yx(cfg: CMCTMConfig, Y, X) -> np.ndarray:
    YX = np.concatenate([np.asarray(Y, np.float32), np.asarray(X, np.float32)], axis=1)
    if YX.shape[1] != cfg.J + cfg.n_features:
        raise ValueError(f"Y and X must hold J + F = {cfg.J + cfg.n_features} columns, "
                         f"got {YX.shape[1]}")
    return YX


def fit_cmctm(
    cfg: CMCTMConfig,
    scaler: DataScaler,
    Y,
    X,
    weights=None,
    *,
    generator: torch.Generator | None = None,
    init: CMCTMParams | None = None,
    steps: int = 1500,
    lr: float = 5e-2,
    method: str = "adam",
    chunk_size: int | None = None,
    microbatches: int | None = None,
    batch_size: int | None = None,
    history: int = 10,
    gtol: float = 1e-6,
    mesh=None,
    checkpoint=None,
    ckpt_every: int = 0,
    resume: bool = False,
    device=None,
) -> M.FitResult:
    """Weighted conditional-MCTM fit through the fit layer: ``method``
    ``"adam"`` (a single-microbatch fit featurizes once, outside the steps),
    ``"lbfgs"`` (streaming HVP; ``steps`` are iterations, stopping at
    ``gtol``) or ``"minibatch"`` (``batch_size`` sampled rows a step, the
    (y_i, x_i) rows drawn like any other batch); rows beyond ``chunk_size``
    are featurized microbatch by microbatch. ``init`` (or ``init_cparams`` from ``generator``) is the
    start. The final NLL is summed chunk by chunk, each chunk's float32 sum
    added to a float total. ``checkpoint=`` (a ``CheckpointManager``) +
    ``resume=True`` restart from the latest saved step (``ckpt_every``
    steps apart), in both modes. ``mesh``: data parallel on the mesh's
    device (module doc)."""
    from repro_torch.core.mctm_fit import (
        default_fit_optimizer, fit_density_model, fit_featurize, method_batch_plan,
    )

    from repro_torch.core.distributed_coreset import rank_rows

    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    YX = _stack_yx(cfg, Y, X)
    n = int(YX.shape[0])
    if n == 0:
        raise ValueError("cannot fit an empty dataset")
    w, _, chunk, microbatches, batch_size, norm = method_batch_plan(
        method, n, weights, chunk_size, microbatches, batch_size, mesh)
    if init is None:
        init = init_cparams(cfg, generator=generator, device=dev)
    model = CMCTMDensityModel(cfg, scaler, norm=norm)
    YXt = torch.as_tensor(YX, device=dev)
    wt = torch.as_tensor(w, device=dev)
    if method == "adam" and microbatches == 1:
        A, Ap = fit_featurize(cfg.base, scaler)(YXt[:, : cfg.J])
        batch = {"A": A, "Ap": Ap, "X": YXt[:, cfg.J:], "weights": wt}
    else:
        batch = {"YX": YXt, "weights": wt}
    params, losses = fit_density_model(
        model, init, batch, optimizer=default_fit_optimizer(lr, steps), steps=steps,
        method=method, microbatches=microbatches, batch_size=batch_size, history=history,
        gtol=gtol, checkpoint=checkpoint, ckpt_every=ckpt_every, resume=resume,
        label=f"cmctm-{method}", device=dev, mesh=mesh,
    )
    params = CMCTMParams(*(t.detach() for t in params))
    lo0, hi0 = 0, n
    if mesh is not None:  # this rank's rows of the scoring layout
        lo0, hi0, chunk, _ = rank_rows(mesh, n, chunk)
    final = 0.0
    with torch.no_grad():
        for lo in range(lo0, hi0, chunk):
            hi = min(lo + chunk, hi0)
            c = {"YX": YXt[lo:hi]}
            final += float(torch.sum(wt[lo:hi] * cnll_terms(cfg, params, *model.features(c))))
    if mesh is not None:
        final = float(mesh.fold_host(np.array([final]))[0])
    return M.FitResult(params=params, losses=losses, final_nll=final)


# ---------------------------------------------------------------------------
# conditional coreset: leverage over the augmented feature row (b_i, x_i)
# ---------------------------------------------------------------------------


def _conditional_featurize(cfg: CMCTMConfig, scaler: DataScaler) -> Callable:
    """The engine's featurize of a chunk of rows (y_i, x_i): one bernstein
    launch on the y columns gives the leverage rows (b_i, x_i) (c, dJ + F)
    and the derivative rows (c·J, d) the hull stage queries."""
    base = _mctm_featurize(cfg.base, scaler)

    def featurize(YX: torch.Tensor):
        Xb, P = base(YX[:, : cfg.J].contiguous())
        return torch.cat([Xb, YX[:, cfg.J:]], dim=1), P

    return featurize


def conditional_scoring_engine(
    cfg: CMCTMConfig, scaler: DataScaler, chunk_size: int | None = DEFAULT_CHUNK, *,
    device=None,
) -> ScoringEngine:
    """Chunked scoring engine over the augmented conditional feature rows."""
    return ScoringEngine(featurize=_conditional_featurize(cfg, scaler), chunk_size=chunk_size,
                         rows_per_point=cfg.J, device=device)


def conditional_coreset_scores(
    cfg: CMCTMConfig,
    scaler: DataScaler,
    Y,
    X,
    *,
    chunk_size: int | None = DEFAULT_CHUNK,
    sketch_size: int = 0,
    plan=None,
    generator: torch.Generator | None = None,
    device=None,
) -> np.ndarray:
    """s_i = u_i + 1/n over the augmented rows (b_i, x_i), chunked;
    ``sketch_size > 0`` streams them once through the one-pass sketched
    strategy (``plan`` or ``generator`` for the CountSketch)."""
    engine = conditional_scoring_engine(cfg, scaler, chunk_size, device=device)
    return engine.score(_stack_yx(cfg, Y, X), method="l2-only", sketch_size=sketch_size,
                        plan=plan, generator=generator).scores


def build_conditional_coreset(
    cfg: CMCTMConfig,
    scaler: DataScaler,
    Y,
    X,
    k: int,
    *,
    generator: torch.Generator | None = None,
    alpha: float = 0.8,
    chunk_size: int | None = DEFAULT_CHUNK,
    sketch_size: int = 0,
    plan=None,
    hull_normals=None,
    draw=None,
    device=None,
):
    """Algorithm 1's hybrid for the conditional model; returns (idx, weights).

    One engine run gives the sampling scores and the hull candidates. The
    result has exactly ``min(k, n)`` entries: when the hull rows dedup to
    fewer than k − ⌊αk⌋ distinct points (low-diversity hulls), the shortfall
    is topped up from the next-ranked points by score."""
    t0 = time.perf_counter()
    YX = _stack_yx(cfg, Y, X)
    n = YX.shape[0]
    k = min(k, n)
    k2 = k - int(np.floor(alpha * k))
    method = "l2-hull" if k2 > 0 else "l2-only"
    engine = conditional_scoring_engine(cfg, scaler, chunk_size, device=device)
    res = engine.score(YX, method=method, hull_k=k2, hull_normals=hull_normals,
                       sketch_size=sketch_size, plan=plan, generator=generator)
    cs = coreset_from_scoring(res, n, k, method, alpha, t0, generator=generator, draw=draw)
    return cs.indices, cs.weights
