"""MCTM fit layer — the single-host port of ``repro.core.mctm_fit``:
streamed featurization, the weighted-NLL fits (``adam``, ``lbfgs``,
``minibatch``), and the streamed full-data evaluator behind the (1±ε)
validation.

Objective: Σ w·nll(θ) / Σw. ``method_batch_plan`` owns the microbatch and
normalizer rules (adam: norm = Σw / microbatches, so the mean over
microbatches of each microbatch's Σ w·nll / norm is the objective; lbfgs:
norm = Σw, its oracles sum over microbatches; minibatch: norm =
Σw·batch_size / (n·microbatches), so a sampled batch's estimate is
unbiased). Every step featurizes each
microbatch inside the loss (the bernstein kernel; the features are
constants of the fit, so no backward kernel is needed).

- ``adam``: sums the microbatch gradients, scales them by 1/microbatches and
  applies the reference's AdamW update — the arithmetic of
  ``repro.train.trainer``'s ``make_train_step``. A single-microbatch adam
  fit featurizes once, outside the step loop (the dense fast path).
- ``minibatch``: adam's step on ``batch_size`` rows drawn each step through
  ``data.pipeline.full_data_loader`` (uniform with replacement, or
  w-proportional with ``sampling="importance"``), the bernstein kernel
  featurizing them inside the loss. A batch is a pure function of
  (``sample_seed``, step), so a resumed fit replays the straight run's
  draws; with the ``ft`` config's ``straggler_deadline_ms > 0`` a slow
  draw is replaced by the backup draw of the same step
  (``with_backup_draws``). adam and minibatch share one ``TrainState``
  driver (``_train_state_loop``).
- ``lbfgs``: the streaming-HVP quasi-Newton fit (``_fit_lbfgs``): loss,
  gradient and Hessian-vector product each one sweep over the microbatches
  on the device (``make_streamed_oracles``); the two-loop direction, the
  Armijo bookkeeping and the curvature ring on the host in float64, the
  state stored in float32 between iterations, as the reference stores it.

No path holds an (n, J, d) basis beyond one chunk otherwise.

With ``mesh=`` (a ``repro_torch.distributed.DataMesh``) every mode runs data
parallel, one rank per device: rows are padded to a multiple of
microbatches × shards with zero weight and rank r takes the r-th contiguous
slice of the padded batch (a minibatch step, the r-th slice of the batch
every rank draws alike); each adam or minibatch step folds its loss and
gradient once (``DataMesh.fold``: one gather, summed in rank order, so every
rank applies the same update), and each lbfgs oracle sweep (value and
gradient, value, HVP) folds once, after which the host's f64 two-loop and
Armijo run identically on every rank. The supervisor takes the mesh
(``RunSupervisor(mesh=)``), and a ``CheckpointManager(mesh=)`` writes from
rank 0. At world 1 a fold is the identity: the fit is the single-device
fit, bit for bit.
``mctm.fit_mctm(method="scipy-lbfgs")`` is the dense small-n oracle that
lbfgs is tested against.

``streamed_nll`` computes the total weighted NLL chunk by chunk (with
``mesh=``: each rank its rows of ``distributed_coreset.shard_layout``, one
fold of the float64 totals);
``coreset_epsilon`` measures the realized ε̂ = max_θ |NLL_C(θ) − NLL(θ)| /
|NLL(θ)| and ``likelihood_ratio`` the ratio checked against the (1±ε̂) band.

Both fits run their steps through ``train.loop.train_loop`` under an
``ft.RunSupervisor``, as the reference's do: ``checkpoint`` (a
``CheckpointManager``) saves the fit state every ``ckpt_every`` steps and at
the end (adam: ``TrainState`` — step, params, optimizer moments; lbfgs: its
``LBFGSState``), ``resume=True`` restarts from the latest save, and a
retryable failure (an injected fault, a non-finite loss or gradient, which
the loop detects before that state can be saved) rolls back to it — with
the LR backed off by ``optim.scale_updates`` after a non-finite one. Every
step is a deterministic function of the state, so a resumed fit lands on the
straight run's bits. A non-finite objective that repeats on every attempt
(NaN data) ends in the supervisor's "retry budget exhausted" diagnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import mctm as M
from repro_torch.core.scoring import DEFAULT_CHUNK, _mctm_featurize
from repro_torch.device import resolve_device, to_tensor
from repro_torch.distributed.mesh import DataMesh
from repro_torch.ft import RunSupervisor
from repro_torch.ft.config import get_ft_config
from repro_torch.ft.failure import NonFiniteError
from repro_torch.optim import Optimizer, adamw, apply_updates, scale_updates
from repro_torch.train import TrainState, restore_train_state, train_loop

__all__ = [
    "MCTMDensityModel",
    "TrainState",
    "LBFGSState",
    "LAST_LBFGS_SWEEPS",
    "fit_featurize",
    "fit_density_model",
    "fit_mctm_streaming",
    "batch_plan",
    "method_batch_plan",
    "resolve_batch_size",
    "make_streamed_oracles",
    "make_fit_step",
    "streamed_nll",
    "coreset_epsilon",
    "likelihood_ratio",
    "cosine_decay",
    "default_fit_optimizer",
    "FIT_METHODS",
]

FIT_METHODS = ("adam", "lbfgs", "minibatch")


def _check_method(method: str) -> None:
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
    dense fast path). ``norm`` is the constant objective normalizer.
    ``features`` returns the batch entries named by ``feature_keys``;
    ``leaf_type`` is the plain-tensor tuple ``loss_fn`` takes as params."""

    feature_keys = ("A", "Ap")
    leaf_type = M.ParamLeaves

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


def _microbatches(batch: dict, microbatches: int) -> list[dict]:
    """A padded batch cut into ``microbatches`` equal row slices."""
    size = int(batch["weights"].shape[0]) // microbatches
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(microbatches)]


def batch_plan(n: int, weights, chunk_size: int | None, microbatches: int | None):
    """Resolved weights, their total, the chunk length and the microbatch
    count (⌈n/chunk⌉ unless given)."""
    w = np.ones(n, np.float32) if weights is None else np.asarray(weights, np.float32)
    chunk = int(chunk_size) if chunk_size else n
    if microbatches is None:
        microbatches = max(1, -(-n // chunk))
    return w, float(w.sum()), chunk, microbatches


def _mesh_world(mesh) -> int:
    """The shard count: the mesh's world (1 without a mesh)."""
    if mesh is None:
        return 1
    if not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a repro_torch.distributed.DataMesh, got {type(mesh)}")
    return mesh.world


def _rank_slice(batch: dict, mesh) -> dict:
    """Rank r's contiguous 1/shards of a batch whose rows are a multiple of
    the shard count (the whole batch without a mesh)."""
    if mesh is None or mesh.world == 1:
        return batch
    size = int(batch["weights"].shape[0]) // mesh.world
    lo = mesh.rank * size
    return {k: v[lo:lo + size] for k, v in batch.items()}


def resolve_batch_size(batch_size: int, microbatches: int = 1, mesh=None) -> int:
    """Round a requested minibatch size UP to the (microbatches × shards)
    multiple the step geometry needs — sampled batches carry no padding, so
    the size itself must already be divisible."""
    mult = max(1, microbatches) * _mesh_world(mesh)
    return -(-int(batch_size) // mult) * mult


def method_batch_plan(method: str, n: int, weights, chunk_size: int | None,
                      microbatches: int | None, batch_size: int | None = None, mesh=None):
    """``batch_plan`` plus the per-method microbatch and objective-normalizer
    rules, shared by ``fit_mctm_streaming`` and ``conditional.fit_cmctm``:
    returns ``(w, total_w, chunk, microbatches, batch_size, norm)`` where,
    so that the fit minimizes Σ w·nll / Σw, adam's norm = Σw / microbatches
    (its step averages the microbatches), lbfgs's norm = Σw (its oracles sum
    them) and minibatch's norm = Σw·batch_size / (n·microbatches) (a
    batch_size-row draw with replacement makes E[Σ_sampled w·nll] =
    (batch_size/n)·Σ w·nll); ``batch_size`` is None but for minibatch."""
    _check_method(method)
    _mesh_world(mesh)
    w, total_w, chunk, mb_full = batch_plan(n, weights, chunk_size, microbatches)
    if method == "minibatch":
        # clamp to n: past that, extra with-replacement draws only add cost
        # and variance over a full-batch step of the same size
        bs = min(int(batch_size), n) if batch_size else min(n, 4096)
        mb = microbatches or max(1, -(-bs // chunk))
        bs = resolve_batch_size(bs, mb, mesh)
        return w, total_w, chunk, mb, bs, total_w * bs / (n * mb)
    if method == "lbfgs":
        return w, total_w, chunk, mb_full, None, total_w
    return w, total_w, chunk, mb_full, None, total_w / mb_full


def fit_density_model(
    model,
    params0,
    batch: dict,
    *,
    optimizer: Optimizer | None = None,
    steps: int,
    method: str = "adam",
    mesh=None,
    microbatches: int = 1,
    batch_size: int | None = None,
    sample_seed: int = 0,
    sampling: str = "uniform",
    history: int = 10,
    gtol: float = 1e-6,
    max_linesearch: int = 20,
    checkpoint=None,
    ckpt_every: int = 0,
    resume: bool = False,
    log_every: int = 0,
    label: str = "fit",
    device=None,
):
    """The density-fit driver, one ``method=`` contract. ``adam`` (any
    first-order ``optimizer``): rows padded to a microbatch multiple with
    zero weight, one step per iteration, grads summed over microbatches then
    scaled by 1/microbatches; each loss is the objective before that step's
    update. ``minibatch``: the same step on ``batch_size`` weighted rows
    drawn each step (``_fit_minibatch``; ``sample_seed``, ``sampling``).
    ``lbfgs`` ignores ``optimizer`` and runs ``_fit_lbfgs`` (``history``
    curvature pairs, Armijo backtracking capped at ``max_linesearch``
    halvings, convergence at ``gtol`` gradient norm). ``params0`` is any
    parameter tuple (``MCTMParams``, the conditional model's three-leaf
    ``CMCTMParams``): its leaves are optimized in the order of its
    ``_fields`` (the order ``ravel_pytree`` flattens a NamedTuple in) and
    the result is of its own type. ``checkpoint``, ``ckpt_every``,
    ``resume``, ``mesh``: see the module doc. Returns ``(params, losses)``
    with one float per step of the final attempt."""
    _mesh_world(mesh)
    if method == "lbfgs":
        return _fit_lbfgs(
            model, params0, batch, steps=steps, microbatches=microbatches, mesh=mesh,
            history=history, gtol=gtol, max_linesearch=max_linesearch,
            checkpoint=checkpoint, ckpt_every=ckpt_every, resume=resume,
            log_every=log_every, label=label, device=device,
        )
    _check_method(method)
    if optimizer is None:
        raise ValueError(f"method={method!r} requires an optimizer")
    dev = resolve_device(device)
    common = dict(optimizer=optimizer, steps=steps, microbatches=microbatches,
                  checkpoint=checkpoint, ckpt_every=ckpt_every, resume=resume,
                  log_every=log_every, label=label, device=dev, mesh=mesh)
    if method == "minibatch":
        if not batch_size:
            raise ValueError("method='minibatch' requires batch_size")
        return _fit_minibatch(model, params0, batch, batch_size=batch_size,
                              sample_seed=sample_seed, sampling=sampling, **common)
    mb = max(1, microbatches)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    padded = _pad_batch(batch, mb * _mesh_world(mesh))[0]
    mbatches = _microbatches(_rank_slice(padded, mesh), mb)
    # full batch: on the device once, the same microbatches every step
    return _train_state_loop(model, params0, lambda i: mbatches, **common)


def _train_state_loop(
    model,
    params0,
    batch_fn: Callable[[int], list],
    *,
    optimizer: Optimizer,
    steps: int,
    microbatches: int = 1,
    checkpoint=None,
    ckpt_every: int = 0,
    resume: bool = False,
    log_every: int = 0,
    label: str = "fit",
    device=None,
    mesh=None,
):
    """The shared ``TrainState`` driver of the adam and minibatch modes:
    the step, resume, the loop and the supervisor, written once so the two
    first-order modes cannot drift. ``batch_fn(i)`` returns step i's
    ``microbatches`` equal slices (dicts of tensors on ``device``; this
    rank's rows with a mesh, whose step folds its loss and gradient once).

    Supervised (``ft.RunSupervisor``): retryable failures — injected faults,
    non-finite losses or grads (``NonFiniteError`` → LR backoff through
    ``scale_updates``) — roll back to the latest checkpoint and re-run.
    Returns ``(params, losses)`` of the final attempt."""
    dev = device
    mb = max(1, microbatches)
    fields = params0._fields
    leaf_type = getattr(model, "leaf_type", None) or type(params0)

    def attempt(ctx):
        opt = scale_updates(optimizer, ctx.lr_scale)
        # fresh leaves every attempt: the steps update them in place
        params = type(params0)(*(
            getattr(params0, f).detach().to(dev).clone().requires_grad_(True) for f in fields))
        init = opt.init([getattr(params, f) for f in fields])
        state = TrainState(0, params, {k: leaf_type(*v) for k, v in init.items()})
        start = 0
        if resume or ctx.resume:
            state, start = restore_train_state(checkpoint, state)
            state = state._replace(params=type(params0)(*(
                getattr(state.params, f).detach().requires_grad_(True) for f in fields)))
        step = make_fit_step(model, opt, fields, leaf_type, mb, device=dev, mesh=mesh)
        return train_loop(step, state, batch_fn, steps, start=start,
                          mgr=checkpoint, ckpt_every=ckpt_every, log_every=log_every,
                          label=label)

    state, losses = RunSupervisor(label=label, mesh=mesh).run(attempt)
    out = torch.stack(losses).double().cpu().numpy() if losses else np.zeros(0)
    return state.params, out


def make_fit_step(model, opt: Optimizer, fields, leaf_type, microbatches: int = 1, *,
                  device=None, mesh=None):
    """The adam and minibatch modes' step, ``step_fn(state, mbatches) →
    (state', metrics)``: the gradients of ``model.loss_fn`` summed over the
    ``microbatches`` slices (folded once with ``mesh``: one gather, summed in
    rank order) and scaled by 1/microbatches, then ``opt``'s update applied
    to the parameter leaves in place (``apply_updates``: the state's params
    keep their storage; the moments are new tensors). ``fields`` are the
    params' leaf names, ``leaf_type`` the moments' tuple type."""
    mb = max(1, microbatches)
    scale = 1.0 / mb

    def step_fn(state: TrainState, mbatches):
        params = state.params
        leaves = [getattr(params, f) for f in fields]
        if mb == 1:
            loss = model.loss_fn(params, mbatches[0])
            grads = torch.autograd.grad(loss, leaves)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = [torch.zeros_like(p) for p in leaves]
            for mbatch in mbatches:
                li = model.loss_fn(params, mbatch)
                gi = torch.autograd.grad(li, leaves)
                loss = loss + li.detach()
                grads = [a + g for a, g in zip(grads, gi)]
        if mesh is not None:
            loss, *grads = mesh.fold([loss, *grads])
        if mb > 1:
            grads = [g * scale for g in grads]
            loss = loss * scale
        moments = {k: list(v) for k, v in state.opt_state.items()}
        updates, moments = opt.update(grads, moments, leaves, state.step)
        apply_updates(leaves, updates)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        new = TrainState(state.step + 1, params,
                         {k: leaf_type(*v) for k, v in moments.items()})
        return new, {"loss": loss.detach(), "grad_norm": gnorm.detach()}

    return step_fn


def _fit_minibatch(
    model,
    params0,
    batch: dict,
    *,
    optimizer: Optimizer,
    steps: int,
    microbatches: int = 1,
    batch_size: int,
    sample_seed: int = 0,
    sampling: str = "uniform",
    checkpoint=None,
    ckpt_every: int = 0,
    resume: bool = False,
    log_every: int = 0,
    label: str = "minibatch",
    device=None,
    mesh=None,
):
    """Sampled-minibatch driver: each step draws ``batch_size`` weighted rows
    through ``data.pipeline.full_data_loader`` over the full index set
    (uniform with replacement, or w-proportional with the 1/p correction
    under ``sampling="importance"``; the caller's normalizer makes the
    estimate unbiased either way, see ``method_batch_plan``), moves them to
    the device and takes adam's step on them. Batches are a pure function of
    (sample_seed, step), so a resumed fit replays the straight run's draws.

    With the ``ft`` config's ``straggler_deadline_ms > 0`` each primary draw
    is deadlined (``data.pipeline.with_backup_draws`` under
    ``ft.failure.StragglerPolicy``): a draw slower than the deadline is
    replaced by the deterministic backup draw of the same step (seed
    ``sample_seed + BACKUP_SEED_OFFSET``), also pure in the step."""
    from repro_torch.data.pipeline import BACKUP_SEED_OFFSET, full_data_loader, with_backup_draws
    from repro_torch.ft.failure import StragglerPolicy

    microbatches = max(1, microbatches)
    dev = device
    w = np.asarray(_host(batch["weights"]), np.float32)
    b = resolve_batch_size(batch_size, microbatches, mesh)
    data = {k: np.asarray(_host(v)) for k, v in batch.items() if k != "weights"}
    sample_fn = full_data_loader(data, w, b, seed=sample_seed, sampling=sampling)
    ft = get_ft_config()
    if ft.straggler_deadline_ms > 0:
        backup_fn = full_data_loader(data, w, b, seed=sample_seed + BACKUP_SEED_OFFSET,
                                     sampling=sampling)
        sample_fn = with_backup_draws(
            sample_fn, backup_fn,
            StragglerPolicy(deadline_ms=ft.straggler_deadline_ms,
                            backup_factor=ft.straggler_backup_factor),
        )

    def batch_fn(i):
        drawn = _rank_slice(sample_fn(i), mesh)
        drawn = {k: torch.as_tensor(v, device=dev) for k, v in drawn.items()}
        return _microbatches(drawn, microbatches)

    return _train_state_loop(model, params0, batch_fn, optimizer=optimizer, steps=steps,
                             microbatches=microbatches, checkpoint=checkpoint,
                             ckpt_every=ckpt_every, resume=resume, log_every=log_every,
                             label=label, device=dev, mesh=mesh)


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


# ---------------------------------------------------------------------------
# streaming-HVP L-BFGS
# ---------------------------------------------------------------------------


def make_streamed_oracles(model, microbatches: int, mesh=None):
    """``(value_and_grad, value, hvp)`` over a padded batch (tensors whose
    rows are a multiple of ``microbatches``); ``params`` and ``vec`` are
    sequences of tensors in the field order of ``model.leaf_type``.

    Each streams the batch microbatch by microbatch through
    ``model.loss_fn``, which featurizes its rows, so the basis exists one
    (chunk, J, d) block at a time, for the HVP too. Totals are sums over the
    microbatches, in float32: the L-BFGS objective's normalizer is the
    model's ``norm`` alone. The HVP is forward over reverse, as the
    reference's (``torch.func.jvp`` of ``torch.func.grad``), on features
    evaluated first: it tracks the reference's iterates more closely than
    reverse over reverse (final NLL 1.9e-6 against 7.1e-6 relative after
    150 iterations at n = 1,000 on the CPU). With ``mesh`` the batch is the
    rank's rows and each oracle folds its sums once."""
    microbatches = max(1, microbatches)

    def _leaves(params, grad: bool):
        return [p.detach().requires_grad_(grad) for p in params]

    def value_and_grad(params, batch):
        loss, grads = None, None
        for mbatch in _microbatches(batch, microbatches):
            leaves = _leaves(params, True)
            li = model.loss_fn(model.leaf_type(*leaves), mbatch)
            gi = torch.autograd.grad(li, leaves)
            loss = li.detach() if loss is None else loss + li.detach()
            grads = list(gi) if grads is None else [a + g for a, g in zip(grads, gi)]
        if mesh is not None:
            loss, *grads = mesh.fold([loss, *grads])
        return loss, grads

    def value(params, batch):
        with torch.no_grad():
            leaves = model.leaf_type(*_leaves(params, False))
            total = sum(model.loss_fn(leaves, mb) for mb in _microbatches(batch, microbatches))
        return total if mesh is None else mesh.fold([total])[0]

    def hvp(params, vec, batch):
        out = None
        for mbatch in _microbatches(batch, microbatches):
            # features first, outside the transforms: constants of the fit
            fixed = dict(mbatch, **dict(zip(model.feature_keys, model.features(mbatch))))
            grad = torch.func.grad(lambda *lv: model.loss_fn(model.leaf_type(*lv), fixed),
                                   argnums=tuple(range(len(params))))
            _, hv = torch.func.jvp(grad, tuple(p.detach() for p in params), tuple(vec))
            out = list(hv) if out is None else [a + h for a, h in zip(out, hv)]
        return out if mesh is None else mesh.fold(out)

    return value_and_grad, value, hvp


class LBFGSState(NamedTuple):
    """The L-BFGS iteration state, host numpy in float32 between
    iterations, as the reference stores it. The curvature ring holds at
    most ``history`` (s, y, ρ) pairs — O(history·|params|), independent of
    n."""

    step: int               # iteration counter
    flat: np.ndarray        # (P,) f32 current iterate (the leaves in field order)
    loss: np.float32        # objective at ``flat``
    grad: np.ndarray        # (P,) f32 gradient at ``flat`` (fused-oracle carry)
    have_grad: bool         # loss/grad are valid (skip the opening sweep)
    mem_s: np.ndarray       # (history, P) f32 iterate displacements s = x₊ − x
    mem_y: np.ndarray       # (history, P) f32 curvature responses y = ∇²f(x₊)·s
    mem_rho: np.ndarray     # (history,) f32 1 / sᵀy
    count: int              # number of valid pairs (rows [0:count])
    converged: bool         # further steps are no-ops


# Streamed-sweep census of the most recent ``_fit_lbfgs`` call: {"vg": fused
# value-and-grad sweeps, "hvp": HVP sweeps, "iters": active (non-latched)
# iterations}. Read it right after the fit returns.
LAST_LBFGS_SWEEPS: dict[str, int] = {"vg": 0, "hvp": 0, "iters": 0}


def _two_loop(g, S, Yv, rho, count: int):
    """Standard two-loop recursion: approximate H⁻¹·g from the curvature
    ring (rows [0:count], oldest → newest). All host-side f64 on O(m·P)
    data — the history is tiny by construction."""
    q = g.copy()
    alpha = np.zeros(count)
    for i in reversed(range(count)):
        alpha[i] = rho[i] * (S[i] @ q)
        q -= alpha[i] * Yv[i]
    if count:
        gamma = (S[count - 1] @ Yv[count - 1]) / max(
            Yv[count - 1] @ Yv[count - 1], 1e-30
        )
    else:
        gamma = 1.0
    r = gamma * q
    for i in range(count):
        beta = rho[i] * (Yv[i] @ r)
        r += S[i] * (alpha[i] - beta)
    return r


def _fit_lbfgs(
    model,
    params0,
    batch: dict,
    *,
    steps: int,
    microbatches: int = 1,
    history: int = 10,
    gtol: float = 1e-6,
    max_linesearch: int = 20,
    checkpoint=None,
    ckpt_every: int = 0,
    resume: bool = False,
    log_every: int = 0,
    label: str = "lbfgs",
    device=None,
    mesh=None,
):
    """Streaming-HVP L-BFGS: quasi-Newton over the streamed oracles, the
    reference's ``_fit_lbfgs`` on one device.

    About 2 streamed sweeps an iteration: the Armijo backtracker evaluates
    the fused value-and-grad oracle at each candidate, and the accepted
    candidate's (f, ∇f) are carried into the next iteration; one streamed
    HVP sweep a step forms the curvature pair y = ∇²f(x₊)·s. The two-loop
    direction and the ring run on the host in float64 from the float32
    state. Once ``gtol`` is reached, or no Armijo point exists along a
    descent direction, ``converged`` latches and the remaining steps are
    free no-ops that each append the same loss. Every iteration is a
    function of (state, batch) alone, so a checkpointed ``LBFGSState``
    resumes the straight run bit for bit. A non-finite loss raises
    ``NonFiniteError`` (the supervisor's retry, then its diagnostic), as
    does a non-finite gradient norm through ``train_loop``'s check."""
    dev = resolve_device(device)
    microbatches = max(1, microbatches)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    batch, _, _ = _pad_batch(batch, microbatches * _mesh_world(mesh))
    batch = _rank_slice(batch, mesh)
    value_and_grad, _, hvp = make_streamed_oracles(model, microbatches, mesh)
    fields = params0._fields
    shapes = [tuple(getattr(params0, f).shape) for f in fields]
    sizes = [int(np.prod(sh)) for sh in shapes]
    P = sum(sizes)
    m = max(1, int(history))
    sweeps = {"vg": 0, "hvp": 0, "iters": 0}

    def unravel(flat: np.ndarray) -> list[torch.Tensor]:
        flat = torch.as_tensor(np.asarray(flat, np.float32), device=dev)
        parts = torch.split(flat, sizes)
        return [p.reshape(sh) for p, sh in zip(parts, shapes)]

    def ravel(tensors) -> np.ndarray:
        return np.concatenate([t.detach().reshape(-1).cpu().numpy() for t in tensors]).astype(
            np.float64)

    def step_fn(state: LBFGSState, batch) -> tuple[LBFGSState, dict]:
        if state.converged:
            return state._replace(step=state.step + 1), {
                "loss": state.loss, "grad_norm": np.float32(0.0)}
        sweeps["iters"] += 1
        x = np.asarray(state.flat, np.float64)
        if state.have_grad:
            # the sweep that accepted x in the previous line search computed (f, ∇f)
            f0 = float(state.loss)
            g = np.asarray(state.grad, np.float64)
        else:
            loss, grads = value_and_grad(unravel(x), batch)
            sweeps["vg"] += 1
            g = ravel(grads)
            f0 = float(loss)
        gnorm = float(np.linalg.norm(g))
        metrics = {"loss": np.float32(f0), "grad_norm": np.float32(gnorm)}
        if not np.isfinite(f0):
            if get_ft_config().nonfinite_rollback:
                # a deterministic objective: the same on every retry, so the
                # supervisor's budget drains to its diagnostic
                raise NonFiniteError(state.step, loss=f0, grad_norm=gnorm)
            return state._replace(step=state.step + 1, loss=np.float32(f0),
                                  converged=True), metrics
        if gnorm <= gtol:
            return state._replace(step=state.step + 1, loss=np.float32(f0),
                                  converged=True), metrics
        count = state.count
        S = np.asarray(state.mem_s, np.float64)
        Yv = np.asarray(state.mem_y, np.float64)
        rho = np.asarray(state.mem_rho, np.float64)
        d = -_two_loop(g, S, Yv, rho, count)
        gd = float(g @ d)
        if not np.isfinite(gd) or gd >= 0.0:  # ring gone stale → steepest descent
            d, gd = -g, -(gnorm * gnorm)
        t = min(1.0, 1.0 / max(float(np.abs(g).sum()), 1e-12)) if count == 0 else 1.0
        f_t, g_t, armijo = f0, None, False
        for _ in range(max_linesearch):
            # fused trial: value AND gradient in one streamed sweep — the
            # accepted trial's gradient seeds the next iteration free
            loss_t, grads_t = value_and_grad(unravel(x + t * d), batch)
            sweeps["vg"] += 1
            f_t = float(loss_t)
            if np.isfinite(f_t) and f_t <= f0 + 1e-4 * t * gd:
                g_t = ravel(grads_t)
                armijo = True
                break
            t *= 0.5
        if not armijo:
            return state._replace(step=state.step + 1, loss=np.float32(f0),
                                  converged=True), metrics
        s = t * d
        x_new = x + s
        y = ravel(hvp(unravel(x_new), unravel(s), batch))
        sweeps["hvp"] += 1
        sy = float(s @ y)
        # curvature-pair acceptance (skip, don't damp: the HVP y is exact
        # curvature, so a tiny sᵀy means genuinely indefinite local curvature)
        if np.isfinite(sy) and sy > 1e-10 * np.linalg.norm(s) * np.linalg.norm(y):
            if count < m:
                S[count], Yv[count], rho[count] = s, y, 1.0 / sy
                count += 1
            else:
                S, Yv, rho = np.roll(S, -1, 0), np.roll(Yv, -1, 0), np.roll(rho, -1, 0)
                S[-1], Yv[-1], rho[-1] = s, y, 1.0 / sy
        metrics["loss"] = np.float32(f_t)
        return LBFGSState(
            step=state.step + 1, flat=x_new.astype(np.float32), loss=np.float32(f_t),
            grad=g_t.astype(np.float32), have_grad=True, mem_s=S.astype(np.float32),
            mem_y=Yv.astype(np.float32), mem_rho=rho.astype(np.float32), count=count,
            converged=False,
        ), metrics

    flat0 = ravel([getattr(params0, f) for f in fields]).astype(np.float32)

    def attempt(ctx):
        # a fresh iterate every attempt; resume pulls the latest good checkpoint
        state = LBFGSState(
            step=0, flat=flat0.copy(), loss=np.float32(np.inf), grad=np.zeros(P, np.float32),
            have_grad=False, mem_s=np.zeros((m, P), np.float32),
            mem_y=np.zeros((m, P), np.float32), mem_rho=np.zeros(m, np.float32), count=0,
            converged=False,
        )
        start = 0
        if resume or ctx.resume:
            state, start = restore_train_state(checkpoint, state)
        return train_loop(step_fn, state, lambda i: batch, steps, start=start, mgr=checkpoint,
                          ckpt_every=ckpt_every, log_every=log_every, label=label)

    state, losses = RunSupervisor(label=label, mesh=mesh).run(attempt)
    LAST_LBFGS_SWEEPS.clear()
    LAST_LBFGS_SWEEPS.update(sweeps)
    return type(params0)(*unravel(state.flat)), np.asarray([float(x) for x in losses], np.float64)


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
    batch_size: int | None = None,
    sample_seed: int = 0,
    sampling: str = "uniform",
    history: int = 10,
    gtol: float = 1e-6,
    featurize: Callable | None = None,
    checkpoint=None,
    ckpt_every: int = 0,
    resume: bool = False,
    log_every: int = 0,
    mesh=None,
    device=None,
) -> M.FitResult:
    """Weighted maximum-likelihood MCTM fit (``weights`` None → unweighted),
    inputs beyond ``chunk_size`` rows featurized microbatch by microbatch.
    ``init`` (or fresh ``init_params`` from ``generator``) is the start.
    ``method``: ``"adam"`` (any first-order ``optimizer``), ``"lbfgs"``
    (streaming-HVP quasi-Newton; ``steps`` are iterations, early-stopping
    at ``gtol``) or ``"minibatch"`` (``batch_size`` sampled weighted rows a
    step, drawn from ``sample_seed``; ``sampling="importance"`` for
    w-proportional draws with the 1/p correction). ``checkpoint`` /
    ``ckpt_every`` / ``resume``: the fit layer's supervised checkpoints;
    ``mesh``: data parallel over a ``DataMesh`` on its device (module
    doc)."""
    _check_method(method)
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    Y = np.asarray(Y, np.float32)
    n = int(Y.shape[0])
    if n == 0:
        raise ValueError("cannot fit an empty dataset")
    if init is None:
        init = M.init_params(cfg, generator=generator, device=dev)
    w, _, chunk, microbatches, batch_size, norm = method_batch_plan(
        method, n, weights, chunk_size, microbatches, batch_size, mesh
    )
    model = MCTMDensityModel(cfg, scaler, norm=norm, featurize=featurize)
    Yt = torch.as_tensor(Y, device=dev)
    batch = {"Y": Yt, "weights": torch.as_tensor(w, device=dev)}
    if method == "adam" and microbatches == 1 and featurize is None:
        # dense fast path: featurize once instead of once per step (adam
        # only: lbfgs holds its batch across many oracle sweeps, where a
        # cached (n, J, d) basis is what this layer exists to avoid, and
        # minibatch rows change every step)
        A, Ap = fit_featurize(cfg, scaler)(Yt)
        batch = {"A": A, "Ap": Ap, "weights": batch["weights"]}
    params, losses = fit_density_model(
        model, init, batch,
        optimizer=optimizer or default_fit_optimizer(lr, steps),
        steps=steps, method=method, microbatches=microbatches, batch_size=batch_size,
        sample_seed=sample_seed, sampling=sampling, history=history, gtol=gtol,
        checkpoint=checkpoint, ckpt_every=ckpt_every, resume=resume,
        log_every=log_every, label=f"mctm-{method}", device=dev, mesh=mesh,
    )
    final = streamed_nll(
        cfg, scaler, params, Y, weights=None if weights is None else w,
        chunk=chunk, featurize=featurize, mesh=mesh, device=dev,
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
    mesh=None,
    axis="data",
    device=None,
) -> float:
    """Total (weighted) NLL Σ w·nll(θ), streamed chunk by chunk (each
    chunk's f32 sum added to a float64 total, read once). ``eta`` overrides the
    Jacobian floor (``eta=1e-9``: strict evaluation). With ``mesh`` each
    rank streams its rows of the scoring engine's layout
    (``shard_layout``) and the totals fold once; every rank returns the
    same float."""
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    cfg_eval = dataclasses.replace(cfg, eta=eta) if eta is not None else cfg
    feat = fit_featurize(cfg_eval, scaler, featurize)
    n = int(np.shape(Y)[0])
    c = int(chunk) if chunk else n
    lo, hi = 0, n
    if mesh is not None:
        from repro_torch.core.distributed_coreset import rank_rows

        lo, hi, c, _ = rank_rows(mesh, n, chunk, axis)
    Y = to_tensor(Y[lo:hi] if isinstance(Y, torch.Tensor) else np.asarray(Y)[lo:hi],
                  torch.float32, dev)
    w = (
        torch.ones(hi - lo, dtype=torch.float32, device=dev)
        if weights is None
        else to_tensor(weights[lo:hi] if isinstance(weights, torch.Tensor)
                       else np.asarray(weights)[lo:hi], torch.float32, dev)
    )
    # each chunk's f32 sum added to a float64 total on the device (the
    # sums a host float would take, without a host read a chunk)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    with torch.no_grad():
        for a in range(0, hi - lo, c):
            b = min(a + c, hi - lo)
            total = total + _chunk_nll(feat, cfg_eval, params, Y[a:b], w[a:b]).double()
    if mesh is not None:
        total = mesh.fold([total])[0]
    return float(total)


def _chunk_nll(feat, cfg: M.MCTMConfig, params, Yc, wc) -> torch.Tensor:
    """Σ w·nll of one (chunk, J) block, f32: the featurize, then
    ``nll_terms`` (the body of ``streamed_nll``'s sweep)."""
    A, Ap = feat(Yc)
    return torch.sum(wc * M.nll_terms(cfg, params, A, Ap))


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
    mesh=None,
    axis="data",
    device=None,
) -> float:
    """Measured ε̂ = max_θ |Σ w·nll_C(θ) − NLL_full(θ)| / |NLL_full(θ)| over
    ``params_list``; ``full_nlls`` may carry precomputed full-data NLLs. The
    full-data side streams on ``mesh`` when given, the (small) coreset side
    on every rank alike."""
    if full_nlls is None:
        full_nlls = [None] * len(params_list)
    eps = 0.0
    for p, full in zip(params_list, full_nlls):
        if full is None:
            full = streamed_nll(cfg, scaler, p, Y, chunk=chunk, eta=eta, mesh=mesh, axis=axis,
                                device=device)
        cs = streamed_nll(cfg, scaler, p, cs_Y, weights=cs_weights, chunk=chunk, eta=eta,
                          device=device if mesh is None or device is not None else mesh.device)
        eps = max(eps, abs(cs - full) / max(abs(full), 1e-9))
    return float(eps)
