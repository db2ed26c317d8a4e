"""Data pipeline with the paper's coreset selection as a first-class stage —
the single-host port of ``repro.data.pipeline``.

Components:
  * ``ShardedLoader`` — deterministic, resumable batch iterator with
    background prefetch. Every batch is a pure function of (seed, step), so
    restart-after-failure replays exactly.
  * ``CoresetSelector`` — the paper's Algorithm 1 lifted to generic training
    data: featurize examples (any row-wise callable, e.g. embedding
    pooling), score ℓ2 leverage + uniform sensitivity on the port's
    ``ScoringEngine`` (the gram, sweep and extremes kernels on the card),
    augment with directional hull extremes of the feature rows themselves
    (P = F, ``rows_per_point=1``), and emit (indices, weights).
  * ``WeightedSubset`` / ``subset_loader`` — iterate coreset-selected data;
    ``full_data_loader`` is the same sampler over ALL rows (the fit layer's
    minibatch mode). Both draw with numpy's
    ``default_rng(SeedSequence([seed, step]))``, as the reference does, so
    their batches are the reference's to the bit.
  * ``with_backup_draws`` — a deadlined primary draw with the deterministic
    backup draw of the same step (``ft.failure.StragglerPolicy``).

Random draws: torch cannot replay ``jax.random``, so ``select`` takes its
draws as a ``plan`` (the uniform ids, the k1 sample ids, the CountSketch
plan, the hull net's normals or the whole net); what the plan does not
hold comes from the caller's ``torch.Generator``. With ``mesh=`` (a
``repro_torch.distributed.DataMesh``) the selection scores on the mesh
(``core.distributed_coreset.DistributedScoringEngine``): each rank
featurizes and scores only its rows, and every rank returns the same subset.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core.scoring import DEFAULT_CHUNK, ScoringEngine
from repro_torch.device import resolve_device, to_tensor

__all__ = [
    "ShardedLoader",
    "CoresetSelector",
    "WeightedSubset",
    "SAMPLING_MODES",
    "subset_loader",
    "full_data_loader",
    "with_backup_draws",
    "BACKUP_SEED_OFFSET",
]

# seed offset for the deterministic backup draw of the same step (straggler
# mitigation): far from any user seed, the reference's value
BACKUP_SEED_OFFSET = 0x5EED
# the selector hands the engine each example's index as two float32 columns
# (exact to 2³⁶ rows): idx = hi·_INDEX_BASE + lo
_INDEX_BASE = 4096


@dataclasses.dataclass
class ShardedLoader:
    """Deterministic resumable loader. `sample_fn(step) -> dict[str, np.ndarray]`."""

    sample_fn: Callable[[int], dict[str, np.ndarray]]
    start_step: int = 0
    prefetch: int = 2

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            step = self.start_step
            while not stop.is_set():
                try:
                    q.put((step, self.sample_fn(step)), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                step, batch = q.get()
                batch["_step"] = np.asarray(step)
                yield batch
        finally:
            stop.set()

    def state_dict(self, step: int) -> dict:
        return {"start_step": int(step)}


@dataclasses.dataclass
class WeightedSubset:
    indices: np.ndarray
    weights: np.ndarray

    @property
    def size(self) -> int:
        return int(self.indices.shape[0])


class CoresetSelector:
    """Generic ℓ2-hull data reduction (paper Algorithm 1 beyond MCTMs).

    featurize: (examples) → (n, D) feature matrix (an array or a tensor),
    given the examples' rows in the type the caller passed to ``select`` (a
    numpy array or a tensor). It must be ROW-WISE: inputs beyond
    ``chunk_size`` are featurized chunk by chunk (``chunk_size=None`` keeps
    single-call semantics). The feature rows are scored on ``device`` (None
    → CUDA): the exact two-pass strategy, or with ``sketch_size`` the
    one-pass sketched one; the hull queries run on the feature rows
    themselves, so a width past the sweep's 16 columns takes the engine's
    wide-P route.
    """

    def __init__(
        self,
        featurize: Callable,
        *,
        alpha: float = 0.8,
        method: str = "l2-hull",
        chunk_size: int | None = DEFAULT_CHUNK,
        mesh=None,
        axis="data",
        sketch_size: int = 0,
        device=None,
    ):
        if method not in ("l2-hull", "l2-only", "uniform"):
            raise ValueError(method)
        self.featurize = featurize
        self.alpha = alpha
        self.method = method
        self.chunk_size = chunk_size
        self.sketch_size = sketch_size
        self.mesh = mesh
        self.device = mesh.device if mesh is not None and device is None else resolve_device(device)
        self._examples = None

        def _feat(Ic):
            idx = Ic[:, 0].long() * _INDEX_BASE + Ic[:, 1].long()
            ex = self._examples
            rows = ex[idx.to(ex.device)] if isinstance(ex, torch.Tensor) else ex[idx.cpu().numpy()]
            F = to_tensor(self.featurize(rows), torch.float32, self.device)
            return F, F  # hull queries run on the feature rows themselves

        if mesh is None:
            self._engine = ScoringEngine(featurize=_feat, chunk_size=chunk_size,
                                         rows_per_point=1, device=self.device)
        else:
            from repro_torch.core.distributed_coreset import DistributedScoringEngine

            self._engine = DistributedScoringEngine(featurize=_feat, mesh=mesh, axis=axis,
                                                    chunk_size=chunk_size, rows_per_point=1)

    def select(self, examples, k: int, *, generator: torch.Generator | None = None,
               plan: dict | None = None) -> WeightedSubset:
        """k indices and weights. ``plan`` may hold the reference's draws:
        ``"uniform"`` (k distinct ids), ``"draw"`` (the k1 sample ids),
        ``"sketch"`` (the CountSketch rows and signs), ``"hull_normals"``
        or ``"hull_dirs"``; the rest is drawn from ``generator``."""
        plan = plan or {}
        n = int(examples.shape[0])
        k = min(k, n)
        if self.method == "uniform":
            if "uniform" in plan:
                idx = np.asarray(plan["uniform"], np.int64)
            else:
                idx = torch.randperm(n, generator=generator)[:k].numpy()
            return WeightedSubset(idx, np.full(k, n / k, np.float32))

        k1 = int(np.floor(self.alpha * k)) if self.method == "l2-hull" else k
        k2 = k - k1 if self.method == "l2-hull" else 0
        ids = torch.arange(n, dtype=torch.int64)
        index = torch.stack([ids // _INDEX_BASE, ids % _INDEX_BASE], dim=1).float()
        self._examples = examples
        try:
            res = self._engine.score(
                index, method="l2-only", hull_k=k2, sketch_size=self.sketch_size,
                generator=generator, plan=plan.get("sketch"),
                hull_normals=plan.get("hull_normals"), hull_dirs=plan.get("hull_dirs"),
            )
        finally:
            self._examples = None
        probs = res.scores / res.scores.sum()
        if "draw" in plan:
            idx = np.asarray(plan["draw"], np.int64)
        else:
            idx = torch.multinomial(torch.as_tensor(probs, dtype=torch.float64), k1,
                                    replacement=True, generator=generator).numpy()
        w = (1.0 / (k1 * probs[idx])).astype(np.float32)
        if k2 > 0:
            # exactly k2 distinct example ids (rows == points here), topped
            # up by score rank when the hull candidates dedup short
            from repro_torch.core.coreset import exact_hull_points

            hull = exact_hull_points(res, res.scores, k2)
            idx = np.concatenate([idx, hull])
            w = np.concatenate([w, np.ones(k2, np.float32)])
        return WeightedSubset(idx.astype(np.int64), w)


SAMPLING_MODES = ("uniform", "importance")


def subset_loader(
    data: dict[str, np.ndarray],
    subset: WeightedSubset,
    batch: int,
    seed: int = 0,
    sampling: str = "uniform",
) -> Callable[[int], dict[str, np.ndarray]]:
    """sample_fn over a coreset-selected subset, weights attached per example.

    ``sampling`` picks the draw distribution; both are unbiased for the same
    weighted objective under the minibatch fit's ``n/batch`` normalizer:

    * ``"uniform"`` — uniform-with-replacement rows, weights passed through.
    * ``"importance"`` — rows drawn w-proportionally (pᵢ = wᵢ/Σw) with the
      constant 1/p correction Σw/size attached instead, so every batch
      carries the same total weight.

    Each batch is a pure function of (seed, step) in either mode.
    """
    if sampling not in SAMPLING_MODES:
        raise ValueError(f"sampling must be one of {SAMPLING_MODES}: {sampling!r}")
    probs = None
    if sampling == "importance":
        w = np.maximum(np.asarray(subset.weights, np.float64), 0.0)
        total = float(w.sum())
        if total <= 0.0:
            raise ValueError("importance sampling needs positive total weight")
        probs = w / total
        # the constant 1/p-corrected per-row weight Σw/size
        w_corr = np.full(batch, total / subset.size, np.float32)

    def sample_fn(step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        if probs is None:
            pick = rng.integers(0, subset.size, batch)
            w_out = subset.weights[pick]
        else:
            pick = rng.choice(subset.size, size=batch, replace=True, p=probs)
            w_out = w_corr
        rows = subset.indices[pick]
        out = {k: v[rows] for k, v in data.items()}
        out["weights"] = w_out
        return out

    return sample_fn


def full_data_loader(
    data: dict[str, np.ndarray],
    weights: np.ndarray,
    batch: int,
    seed: int = 0,
    sampling: str = "uniform",
) -> Callable[[int], dict[str, np.ndarray]]:
    """``subset_loader`` over the all-rows subset: with-replacement weighted
    draws from the full dataset, a pure function of (seed, step) — the
    minibatch fit's resumable sampler."""
    n = int(next(iter(data.values())).shape[0])
    subset = WeightedSubset(np.arange(n, dtype=np.int64), np.asarray(weights, np.float32))
    return subset_loader(data, subset, batch, seed, sampling)


def with_backup_draws(
    primary_fn: Callable[[int], dict],
    backup_fn: Callable[[int], dict],
    policy,
    clock: Callable[[], float] | None = None,
) -> Callable[[int], dict]:
    """Deadline the primary draw per ``StragglerPolicy``; on a miss, take the
    deterministic backup draw of the SAME step (pure in ``step``, so a
    resumed run replays the identical decision inputs). ``clock`` is
    injectable for tests (defaults to ``time.monotonic``)."""
    import time as _time

    tick = clock if clock is not None else _time.monotonic

    def sample_fn(step: int) -> dict:
        t0 = tick()
        batch = primary_fn(step)
        elapsed_ms = (tick() - t0) * 1e3
        if bool(np.any(policy.decide(np.asarray([elapsed_ms], np.float64)))):
            return backup_fn(step)
        return batch

    return sample_fn
