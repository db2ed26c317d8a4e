"""MCTM fit layer — the single-host ``adam`` part of ``repro.core.mctm_fit``:
streamed featurization, the weighted-NLL Adam fit, and the streamed
full-data evaluator behind the (1±ε) validation.

Objective: Σ w·nll(θ) / Σw. ``method_batch_plan`` owns the microbatch and
normalizer rules (adam: norm = Σw / microbatches, so the mean over
microbatches of each microbatch's Σ w·nll / norm is the objective). The step
featurizes each microbatch inside the loss (the bernstein kernel; the
features are constants of the fit, so no backward kernel is needed), sums
the microbatch gradients, scales them by 1/microbatches and applies the
reference's AdamW update — the arithmetic of ``repro.train.trainer``'s
``make_train_step``. A single-microbatch adam fit featurizes once, outside
the step loop (the dense fast path). No path holds an (n, J, d) basis beyond
one chunk otherwise.

``streamed_nll`` computes the total weighted NLL chunk by chunk;
``coreset_epsilon`` measures the realized ε̂ = max_θ |NLL_C(θ) − NLL(θ)| /
|NLL(θ)| and ``likelihood_ratio`` the ratio checked against the (1±ε̂) band.

Not ported yet (they raise ``NotImplementedError``): the ``lbfgs`` and
``minibatch`` methods, ``scipy-lbfgs``, meshes, checkpoints and the
fault-tolerance supervisor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import mctm as M
from repro_torch.core.scoring import DEFAULT_CHUNK, _mctm_featurize
from repro_torch.device import resolve_device, to_tensor
from repro_torch.optim import Optimizer, adamw, apply_updates

__all__ = [
    "MCTMDensityModel",
    "fit_featurize",
    "fit_density_model",
    "fit_mctm_streaming",
    "batch_plan",
    "method_batch_plan",
    "streamed_nll",
    "coreset_epsilon",
    "likelihood_ratio",
    "cosine_decay",
    "default_fit_optimizer",
    "FIT_METHODS",
]

FIT_METHODS = ("adam", "lbfgs", "minibatch")
_NOT_PORTED = ("lbfgs", "minibatch", "scipy-lbfgs")


def _check_method(method: str) -> None:
    if method in _NOT_PORTED:
        raise NotImplementedError(f"fit method {method!r} is not ported yet (adam only)")
    if method not in FIT_METHODS:
        raise ValueError(f"unknown fit method: {method!r} (one of {FIT_METHODS})")


def cosine_decay(lr: float, steps: int):
    """lr·½(1 + cos(π·i/steps)) in float32, the reference's default schedule."""

    def fn(step: int) -> np.float32:
        frac = np.float32(step) / np.float32(max(steps, 1))
        cos = np.cos(np.float32(np.pi) * frac, dtype=np.float32)
        return np.float32(lr) * np.float32(0.5) * (np.float32(1.0) + cos)

    return fn


def default_fit_optimizer(lr: float, steps: int) -> Optimizer:
    """Adam + cosine decay: the reference fit layer's default."""
    return adamw(cosine_decay(lr, steps), b1=0.9, b2=0.999, eps=1e-8)


def fit_featurize(cfg: M.MCTMConfig, scaler, featurize: Callable | None = None):
    """Chunk featurizer of the fit layer: Y chunk (c, J) → (A, A′) each
    (c, J, d). ``featurize`` overrides the base evaluation with the scoring
    engine's flat (X (c, J·d), P (c·J, d)) contract."""
    base = featurize if featurize is not None else _mctm_featurize(cfg, scaler)

    def feat(Yc):
        X, Pr = base(Yc)
        c = X.shape[0]
        return X.reshape(c, cfg.J, cfg.d), Pr.reshape(c, cfg.J, cfg.d)

    return feat


class MCTMDensityModel:
    """``loss_fn(params, batch)`` of the weighted MCTM objective.

    batch is ``{"Y": (b, J), "weights": (b,)}`` — featurized inside the loss
    — or ``{"A", "Ap", "weights"}`` when the caller featurized already (the
    dense fast path). ``norm`` is the constant objective normalizer."""

    def __init__(self, cfg: M.MCTMConfig, scaler=None, *, norm: float = 1.0,
                 featurize: Callable | None = None):
        self.cfg = cfg
        self.norm = float(norm)
        self._feat = (
            fit_featurize(cfg, scaler, featurize)
            if (scaler is not None or featurize is not None)
            else None
        )

    def features(self, batch):
        if "A" in batch:
            return batch["A"], batch["Ap"]
        return self._feat(batch["Y"])

    def loss_fn(self, params, batch) -> torch.Tensor:
        A, Ap = self.features(batch)
        terms = M.nll_terms(self.cfg, params, A, Ap)
        w = batch.get("weights")
        total = torch.sum(terms if w is None else w * terms)
        return total / self.norm


def _pad_batch(batch: dict, multiple: int) -> tuple[dict, int, int]:
    """Pad batch rows (tensors) to a multiple: zero weights, row-0 copies
    elsewhere (valid data — no NaN through the featurizer). Returns
    (batch, n, n_pad)."""
    n = int(batch["weights"].shape[0])
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return batch, n, n_pad
    pad = n_pad - n
    out = {}
    for k, v in batch.items():
        fill = torch.zeros_like(v[:1]) if k == "weights" else v[:1]
        out[k] = torch.cat([v, fill.expand((pad,) + tuple(v.shape[1:]))])
    return out, n, n_pad


def batch_plan(n: int, weights, chunk_size: int | None, microbatches: int | None):
    """Resolved weights, their total, the chunk length and the microbatch
    count (⌈n/chunk⌉ unless given)."""
    w = np.ones(n, np.float32) if weights is None else np.asarray(weights, np.float32)
    chunk = int(chunk_size) if chunk_size else n
    if microbatches is None:
        microbatches = max(1, -(-n // chunk))
    return w, float(w.sum()), chunk, microbatches


def method_batch_plan(method: str, n: int, weights, chunk_size: int | None,
                      microbatches: int | None):
    """``batch_plan`` plus the per-method objective normalizer: returns
    ``(w, total_w, chunk, microbatches, norm)``; for adam
    norm = Σw / microbatches."""
    _check_method(method)
    w, total_w, chunk, mb = batch_plan(n, weights, chunk_size, microbatches)
    return w, total_w, chunk, mb, total_w / mb


def fit_density_model(
    model,
    params0: M.MCTMParams,
    batch: dict,
    *,
    optimizer: Optimizer,
    steps: int,
    method: str = "adam",
    microbatches: int = 1,
    log_every: int = 0,
    label: str = "fit",
    device=None,
):
    """Full-batch first-order fit: rows padded to a microbatch multiple with
    zero weight, one step per iteration, grads summed over microbatches then
    scaled by 1/microbatches. Returns ``(params, losses)`` with one float
    per step (each the objective before that step's update)."""
    _check_method(method)
    dev = resolve_device(device)
    mb = max(1, microbatches)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    batch, _, n_pad = _pad_batch(batch, mb)
    size = n_pad // mb
    mbatches = [{k: v[i * size:(i + 1) * size] for k, v in batch.items()} for i in range(mb)]
    params = M.MCTMParams(
        params0.theta_raw.detach().to(dev).clone(), params0.lam.detach().to(dev).clone()
    )
    leaves = [params.theta_raw, params.lam]
    opt_state = optimizer.init(leaves)
    losses = []
    scale = 1.0 / mb
    for step in range(steps):
        if mb == 1:
            loss = model.loss_fn(params, mbatches[0])
            grads = torch.autograd.grad(loss, leaves)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros_like(p) for p in leaves]
            for mbatch in mbatches:
                li = model.loss_fn(params, mbatch)
                gi = torch.autograd.grad(li, leaves)
                loss = loss + li.detach()
                grads = [a + g for a, g in zip(grads, gi)]
            grads = [g * scale for g in grads]
            loss = loss * scale
        updates, opt_state = optimizer.update(grads, opt_state, leaves, step)
        apply_updates(leaves, updates)
        losses.append(loss.detach())
        if log_every and (step + 1) % log_every == 0:
            print(f"[{label}] step {step + 1:5d} loss {float(loss):.4f}", flush=True)
    out = torch.stack(losses).double().cpu().numpy() if losses else np.zeros(0)
    if not np.all(np.isfinite(out)):
        raise FloatingPointError(f"[{label}] non-finite loss during the fit")
    return params, out


def fit_mctm_streaming(
    cfg: M.MCTMConfig,
    scaler,
    Y,
    weights=None,
    *,
    generator: torch.Generator | None = None,
    init: M.MCTMParams | None = None,
    steps: int = 1500,
    lr: float = 5e-2,
    optimizer: Optimizer | None = None,
    method: str = "adam",
    chunk_size: int | None = DEFAULT_CHUNK,
    microbatches: int | None = None,
    featurize: Callable | None = None,
    log_every: int = 0,
    device=None,
) -> M.FitResult:
    """Weighted maximum-likelihood MCTM fit (``weights`` None → unweighted),
    inputs beyond ``chunk_size`` rows featurized microbatch by microbatch.
    ``init`` (or fresh ``init_params`` from ``generator``) is the start."""
    _check_method(method)
    dev = resolve_device(device)
    Y = np.asarray(Y, np.float32)
    n = int(Y.shape[0])
    if n == 0:
        raise ValueError("cannot fit an empty dataset")
    if init is None:
        init = M.init_params(cfg, generator=generator, device=dev)
    w, _, chunk, microbatches, norm = method_batch_plan(
        method, n, weights, chunk_size, microbatches
    )
    model = MCTMDensityModel(cfg, scaler, norm=norm, featurize=featurize)
    Yt = torch.as_tensor(Y, device=dev)
    batch = {"Y": Yt, "weights": torch.as_tensor(w, device=dev)}
    if microbatches == 1 and featurize is None:
        # dense fast path: featurize once instead of once per step
        A, Ap = fit_featurize(cfg, scaler)(Yt)
        batch = {"A": A, "Ap": Ap, "weights": batch["weights"]}
    params, losses = fit_density_model(
        model, init, batch,
        optimizer=optimizer or default_fit_optimizer(lr, steps),
        steps=steps, method=method, microbatches=microbatches,
        log_every=log_every, label=f"mctm-{method}", device=dev,
    )
    final = streamed_nll(
        cfg, scaler, params, Y, weights=None if weights is None else w,
        chunk=chunk, featurize=featurize, device=dev,
    )
    return M.FitResult(params=params, losses=losses, final_nll=float(final))


def streamed_nll(
    cfg: M.MCTMConfig,
    scaler,
    params: M.MCTMParams,
    Y,
    weights=None,
    *,
    chunk: int | None = DEFAULT_CHUNK,
    featurize: Callable | None = None,
    eta: float | None = None,
    device=None,
) -> float:
    """Total (weighted) NLL Σ w·nll(θ), streamed chunk by chunk (each
    chunk's f32 sum added to a float64 total). ``eta`` overrides the
    Jacobian floor (``eta=1e-9``: strict evaluation)."""
    dev = resolve_device(device)
    cfg_eval = dataclasses.replace(cfg, eta=eta) if eta is not None else cfg
    feat = fit_featurize(cfg_eval, scaler, featurize)
    Y = to_tensor(Y, torch.float32, dev)
    n = int(Y.shape[0])
    w = (
        torch.ones(n, dtype=torch.float32, device=dev)
        if weights is None
        else to_tensor(weights, torch.float32, dev)
    )
    c = int(chunk) if chunk else n
    total = 0.0
    with torch.no_grad():
        for lo in range(0, n, c):
            hi = min(lo + c, n)
            A, Ap = feat(Y[lo:hi])
            total += float(torch.sum(w[lo:hi] * M.nll_terms(cfg_eval, params, A, Ap)))
    return total


def likelihood_ratio(nll_model: float, nll_ref: float) -> float:
    """1 + (NLL_model − NLL_ref)/|NLL_ref|: the raw ratio for positive
    references, the paper's shift normalization otherwise."""
    return float(1.0 + (nll_model - nll_ref) / max(abs(nll_ref), 1e-6))


def coreset_epsilon(
    cfg: M.MCTMConfig,
    scaler,
    Y,
    cs_Y,
    cs_weights,
    params_list,
    *,
    chunk: int | None = DEFAULT_CHUNK,
    eta: float | None = None,
    full_nlls=None,
    device=None,
) -> float:
    """Measured ε̂ = max_θ |Σ w·nll_C(θ) − NLL_full(θ)| / |NLL_full(θ)| over
    ``params_list``; ``full_nlls`` may carry precomputed full-data NLLs."""
    if full_nlls is None:
        full_nlls = [None] * len(params_list)
    eps = 0.0
    for p, full in zip(params_list, full_nlls):
        if full is None:
            full = streamed_nll(cfg, scaler, p, Y, chunk=chunk, eta=eta, device=device)
        cs = streamed_nll(cfg, scaler, p, cs_Y, weights=cs_weights, chunk=chunk, eta=eta,
                          device=device)
        eps = max(eps, abs(cs - full) / max(abs(full), 1e-9))
    return float(eps)
