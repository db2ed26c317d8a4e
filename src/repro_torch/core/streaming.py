"""Merge & Reduce streaming coreset maintenance (paper §4, Geppert et al.
2020) — the single-host port of ``repro.core.streaming``.

Insertion-only streams: incoming chunks are reduced to weighted coresets and
merged pairwise up a binary tree, keeping O(log(n/chunk)) buckets. Reducing
a *weighted* set uses √w-weighted leverage scores plus the hull
augmentation (one ``ScoringEngine`` sweep, on the card's kernels), so the
stream result matches the batch construction up to the usual (1±ε) slack.
``sketch_size > 0`` routes every reduce through the one-pass sketched
strategy: each block is featurized and streamed once per reduce.

``StreamingCoresetMaintainer`` adds, as the reference does:

* **Windowing/decay policies** — ``"insertion"`` (the tree), ``"sliding"``
  (only the last W windows contribute: one bucket per window, expired
  buckets evicted exactly), ``"decayed"`` (every live bucket's weights
  shrink by γ per window before the new window merges in; merge-reduce
  conserves mass, so the total is the geometric sum n·(1−γᵀ)/(1−γ)).
* **Two-round direction net** — with ``sketch_size > 0`` each reduce tracks
  the block's hull moments in the same sweep
  (``OnePassSketched(track_moments=True)``) and seeds the next reduce's net
  (``directions_from_moments`` + ``hull_dirs=``).
* **Per-window checkpoints** — ``ckpt_dir`` saves the full state after every
  window (``restore_flat``: the bucket sets are ragged); ``resume()``
  restores it and the caller re-pushes from ``windows_done``.

Randomness: torch cannot replay ``jax.random``, and a resumed stream must
replay its own draws, so every draw comes from a generator seeded by a pure
function of ``(seed, window, stage)`` (``stage_generator``): stage 0 is a
window's chunk reduce, stage L+1 its level-L merge, and ``result()`` uses
the reference's fold order with its own tag (window ``RESULT_TAG``, stage
``n_seen``), so it stays idempotent. A reduce draws the CountSketch plan
(sketch > 0), the hull net's normals and the k1 sample ids. The maintainer's
``plan_hook(window, stage, rows, probs)`` may supply any of them (the parity
tests pass the reference's own draws): it is called with ``probs=None``
before the sweep (keys ``"plan"``, ``"hull_normals"``) and with the
sampling probabilities after it (key ``"draw"``).

``DriftDetector`` (a numpy copy) and ``drift_window_nll`` measure drift for
one host. The drift → refit loop, as the reference's: with a
``serve_engine`` (``serve.density.DensityServeEngine``) and a ``detector``
attached, every pushed window is scored against the engine's live slot
(``drift_window_nll``, ``drift_chunk`` rows at a time); a fired detector
(``auto_trigger=True``) calls ``engine.start_background_refit(scaler,
coreset=result(), generator=…, **refit_kwargs)``, one refit in flight, whose
publish lands between serving ticks; the next window of the new version
re-anchors the detector on the refit's recorded ``fit_nll_pp``. The refit's
draws come from ``stage_generator(seed, REFIT_TAG, window)``. With
``drift_mesh`` (a ``repro_torch.distributed.DataMesh``) each window's NLL
streams on the mesh, one fold of (Σw·nll, Σw) a window
(``drift_window_nll(mesh=)``); ``drift_axis`` names its data axes, checked
against the mesh's as every ``axis=`` is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import mctm as M
from repro_torch.core.bernstein import DataScaler
from repro_torch.core.scoring import (
    DEFAULT_CHUNK,
    OnePassSketched,
    ScoringEngine,
    directions_from_moments,
)
from repro_torch.device import resolve_device, to_tensor
from repro_torch.ft.config import maybe_inject

__all__ = [
    "WeightedSet",
    "MergeReduceCoreset",
    "StreamingCoresetMaintainer",
    "DriftDetector",
    "drift_window_nll",
    "stage_generator",
    "STREAM_POLICIES",
    "RESULT_TAG",
    "REFIT_TAG",
]

RESULT_TAG = 0x57E4  # result()'s window tag, as the reference folds it
REFIT_TAG = 0xD21F   # the drift-triggered refit's tag, as the reference folds it


def stage_generator(seed: int, window: int, stage: int) -> torch.Generator:
    """A CPU generator seeded by a pure function of (seed, window, stage)."""
    ss = np.random.SeedSequence([int(seed), int(window), int(stage)])
    return torch.Generator().manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))


@dataclasses.dataclass
class WeightedSet:
    Y: np.ndarray        # (m, J)
    weights: np.ndarray  # (m,)

    @property
    def size(self) -> int:
        return int(self.Y.shape[0])

    @staticmethod
    def concat(a: "WeightedSet", b: "WeightedSet") -> "WeightedSet":
        return WeightedSet(
            Y=np.concatenate([a.Y, b.Y], axis=0),
            weights=np.concatenate([a.weights, b.weights], axis=0),
        )


def _weighted_reduce(engine: ScoringEngine, ws: WeightedSet, k: int, alpha: float,
                     sketch_size: int, gen: torch.Generator, hook, *, two_round=False,
                     moments=None):
    """Weighted ℓ2-hull reduction of ``ws`` to ≤ k points, the reference's
    ``_reduce``: one engine sweep (√w leverage + hull extremes), k1 = ⌊αk⌋
    draws ∝ score with weights w/(k1·p), k2 = k − k1 distinct hull points
    at their own weights, the sampled part rescaled so Σw is conserved.
    ``two_round``: a sketched sweep tracks this block's hull moments, and
    ``moments`` (s1, s2, rows) of a previous block seed its net. Returns
    ``(set, this block's moments or None)``."""
    if ws.size <= k:
        return ws, None
    from repro_torch.core.coreset import exact_hull_points

    k1 = int(np.floor(alpha * k))
    k2 = k - k1
    given = hook(ws.size, None) if hook is not None else {}
    strategy = hull_dirs = None
    if sketch_size > 0 and two_round:
        strategy = OnePassSketched(sketch_size, track_moments=True)
        if moments is not None and k2 > 0:
            s1, s2, n_rows = moments
            hull_dirs = directions_from_moments(
                s1, s2, n_rows, k2, engine.hull_oversample,
                normals=given.get("hull_normals"), generator=gen)
    res = engine.score(
        ws.Y, method="l2-hull", weights=ws.weights, hull_k=k2, generator=gen,
        sketch_size=sketch_size, strategy=strategy, plan=given.get("plan"),
        hull_normals=None if hull_dirs is not None else given.get("hull_normals"),
        hull_dirs=hull_dirs,
    )
    scores = res.scores
    probs = scores / scores.sum()
    drawn = hook(ws.size, probs).get("draw") if hook is not None else None
    if drawn is not None:
        idx = np.asarray(drawn, np.int64)
    else:
        idx = torch.multinomial(torch.as_tensor(probs, dtype=torch.float64), k1,
                                replacement=True, generator=gen).numpy()
    w = ws.weights[idx] / (k1 * probs[idx])
    hull_pts = exact_hull_points(res, scores, k2) if k2 > 0 else np.zeros(0, np.int64)
    hull_w = ws.weights[hull_pts]
    # conserve the total mass: rescale the sampled part so Σw_out = Σw_in
    total_in = ws.weights.sum()
    target = max(total_in - hull_w.sum(), 1e-9)
    w = w * (target / max(w.sum(), 1e-9))
    out = WeightedSet(Y=np.concatenate([ws.Y[idx], ws.Y[hull_pts]], axis=0),
                      weights=np.concatenate([w, hull_w], axis=0))
    return out, res.moments


def _hook_at(plan_hook, window: int, stage: int):
    if plan_hook is None:
        return None
    return lambda rows, probs: plan_hook(window, stage, rows, probs) or {}


class MergeReduceCoreset:
    """Streaming coreset: push chunks, read ``result()`` any time. The i-th
    reduce draws from ``stage_generator(seed, i, 0)``; ``result()`` from
    ``stage_generator(seed, RESULT_TAG, n_seen)``, so it is idempotent and
    never perturbs later pushes."""

    def __init__(
        self,
        cfg: M.MCTMConfig,
        scaler: DataScaler,
        k: int,
        seed: int = 0,
        alpha: float = 0.8,
        chunk_size: int | None = DEFAULT_CHUNK,
        sketch_size: int = 0,
        *,
        device=None,
    ):
        self.cfg = cfg
        self.scaler = scaler
        self.k = k
        self.alpha = alpha
        self.sketch_size = sketch_size
        self.seed = int(seed)
        self._buckets: list[WeightedSet | None] = []
        self._reduces = 0
        self.n_seen = 0
        self._engine = ScoringEngine(cfg, scaler, chunk_size=chunk_size, device=device)

    def _reduce(self, ws: WeightedSet, window: int, stage: int) -> WeightedSet:
        return _weighted_reduce(self._engine, ws, self.k, self.alpha, self.sketch_size,
                                stage_generator(self.seed, window, stage), None)[0]

    def _next(self, ws: WeightedSet) -> WeightedSet:
        i = self._reduces
        self._reduces += 1
        return self._reduce(ws, i, 0)

    def push(self, chunk: np.ndarray) -> None:
        """Insert a data chunk; merge carries up the bucket tree."""
        chunk = np.asarray(chunk)
        self.n_seen += chunk.shape[0]
        carry = self._next(WeightedSet(chunk, np.ones(chunk.shape[0])))
        level = 0
        while True:
            if level >= len(self._buckets):
                self._buckets.append(carry)
                return
            if self._buckets[level] is None:
                self._buckets[level] = carry
                return
            merged = WeightedSet.concat(self._buckets[level], carry)
            self._buckets[level] = None
            carry = self._next(merged)
            level += 1

    def result(self) -> WeightedSet:
        """Union of live buckets, reduced once more to ≤ k points."""
        live = [b for b in self._buckets if b is not None]
        if not live:
            return WeightedSet(np.zeros((0, self.cfg.J)), np.zeros((0,)))
        acc = live[0]
        for b in live[1:]:
            acc = WeightedSet.concat(acc, b)
        return self._reduce(acc, RESULT_TAG, self.n_seen)


# ---------------------------------------------------------------------------
# drift: the per-window NLL and the detector
# ---------------------------------------------------------------------------


def drift_window_nll(
    cfg: M.MCTMConfig,
    scaler,
    params,
    Y,
    weights=None,
    *,
    chunk: int | None = DEFAULT_CHUNK,
    mesh=None,
    axis=None,
    device=None,
) -> float:
    """Per-weighted-point NLL of one stream window under ``params`` (``Y``
    and ``weights`` host arrays or tensors): Σw·nll / Σw, streamed chunk by
    chunk (featurize on the bernstein kernel; each chunk's f32 (Σw·nll, Σw)
    added to float64 totals on the device, read once). With ``mesh``
    each rank streams its rows of the scoring layout and the (Σw·nll, Σw)
    pair folds once a window; ``axis`` must then be the mesh's data axes
    (``DataMesh.check_axis``; None: the mesh's own). Without a mesh
    ``axis`` is not read, as in the reference."""
    from repro_torch.core.distributed_coreset import rank_rows
    from repro_torch.core.mctm_fit import fit_featurize

    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    feat = fit_featurize(cfg, scaler)
    if not isinstance(Y, torch.Tensor):
        Y = np.asarray(Y, np.float32)
    n = int(Y.shape[0])
    if n == 0:
        raise ValueError("cannot evaluate an empty window")
    c = int(chunk) if chunk else n
    lo0, hi0 = 0, n
    if mesh is not None:
        lo0, hi0, c, _ = rank_rows(mesh, n, chunk, axis=axis)
    Yt = to_tensor(Y[lo0:hi0], torch.float32, dev)
    if weights is None:
        wt = torch.ones(hi0 - lo0, dtype=torch.float32, device=dev)
    else:
        if not isinstance(weights, torch.Tensor):
            weights = np.asarray(weights, np.float32)
        wt = to_tensor(weights[lo0:hi0], torch.float32, dev)
    # each chunk's f32 pair added to float64 totals on the device, in chunk
    # order (the sums host floats take), folded, divided in float64 as the
    # host would: one read a window
    total = torch.zeros((), dtype=torch.float64, device=dev)
    wsum = torch.zeros((), dtype=torch.float64, device=dev)
    with torch.no_grad():
        for lo in range(0, hi0 - lo0, c):
            hi = min(lo + c, hi0 - lo0)
            pair = _drift_chunk(feat, cfg, params, Yt[lo:hi], wt[lo:hi])
            total = total + pair[0].double()
            wsum = wsum + pair[1].double()
    if mesh is not None:
        total, wsum = mesh.fold([total, wsum])
    return float(total / torch.clamp(wsum, min=1e-9))


def _drift_chunk(feat, cfg: M.MCTMConfig, params, Yc, wc) -> torch.Tensor:
    """(Σw·nll, Σw) of one (chunk, J) block, f32 (2,): the body of
    ``drift_window_nll``'s sweep."""
    A, Ap = feat(Yc)
    return torch.stack([torch.sum(wc * M.nll_terms(cfg, params, A, Ap)), torch.sum(wc)])


class DriftDetector:
    """EWMA band monitor over per-window likelihood ratios (a copy of the
    reference's). Each window's per-point NLL under the live model is
    normalized against a reference anchor (``mctm_fit.likelihood_ratio``)
    and smoothed with an EWMA; the detector fires when the smoothed ratio
    leaves the (1±eps) band after at least ``min_windows`` observations of
    the current model version. A version's first observation re-anchors (to
    ``ref_hint`` when given, else to its own NLL) and never fires.
    ``state()``/``load()`` round-trip the six scalars through the
    maintainer's window checkpoints."""

    def __init__(self, eps: float = 0.1, alpha: float = 0.4, min_windows: int = 2):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        if eps <= 0.0:
            raise ValueError("eps must be positive")
        self.eps = float(eps)
        self.alpha = float(alpha)
        self.min_windows = int(min_windows)
        self.ref_nll_pp: float | None = None
        self.ref_version = -1
        self.ewma = 1.0
        self.last_ratio = 1.0
        self.count = 0
        self.alerts = 0

    @property
    def eps_hat(self) -> float:
        """Measured band deviation |EWMA − 1| — the live ε̂."""
        return abs(self.ewma - 1.0)

    @property
    def in_band(self) -> bool:
        return self.eps_hat <= self.eps

    def observe(self, nll_pp: float, version: int = 0, ref_hint=None) -> bool:
        """Feed one window's per-point NLL; returns True when drift fires."""
        from repro_torch.core.mctm_fit import likelihood_ratio

        nll_pp = float(nll_pp)
        if self.ref_nll_pp is None or int(version) != self.ref_version:
            self.ref_version = int(version)
            self.ref_nll_pp = float(ref_hint) if ref_hint is not None else nll_pp
            self.last_ratio = likelihood_ratio(nll_pp, self.ref_nll_pp)
            self.ewma = self.last_ratio
            self.count = 1
            return False
        self.last_ratio = likelihood_ratio(nll_pp, self.ref_nll_pp)
        self.ewma = (1.0 - self.alpha) * self.ewma + self.alpha * self.last_ratio
        self.count += 1
        fired = self.count >= self.min_windows and not self.in_band
        if fired:
            self.alerts += 1
        return fired

    def state(self) -> np.ndarray:
        """Checkpointable snapshot (f64 — an exact scalar round trip)."""
        return np.asarray(
            [
                np.nan if self.ref_nll_pp is None else self.ref_nll_pp,
                self.ref_version,
                self.ewma,
                self.last_ratio,
                self.count,
                self.alerts,
            ],
            np.float64,
        )

    def load(self, s) -> None:
        s = np.asarray(s, np.float64)
        self.ref_nll_pp = None if np.isnan(s[0]) else float(s[0])
        self.ref_version = int(s[1])
        self.ewma = float(s[2])
        self.last_ratio = float(s[3])
        self.count = int(s[4])
        self.alerts = int(s[5])


# ---------------------------------------------------------------------------
# the production stream consumer
# ---------------------------------------------------------------------------


STREAM_POLICIES = ("insertion", "sliding", "decayed")


@dataclasses.dataclass
class _Bucket:
    """One live merge-reduce bucket: a reduced weighted set plus the window
    that created it (eviction clock) and its tree level."""

    Y: np.ndarray
    w: np.ndarray
    birth: int
    level: int

    def as_ws(self) -> WeightedSet:
        return WeightedSet(self.Y, self.w)


class StreamingCoresetMaintainer:
    """Windowed/decayed merge-reduce over an unbounded stream with the
    two-round direction net (module doc). One ``push(chunk)`` is one
    window. ``ckpt_dir`` checkpoints the full state atomically after every
    window, so crash → ``resume()`` → re-push replays bit-identically.

    Drift loop: with ``serve_engine`` and ``detector`` attached, every
    pushed window is evaluated against the engine's live slot; a fired
    detector (``auto_trigger=True``) starts the engine's background refit on
    ``result()`` (module doc). ``drift_log`` records each window's reading,
    ``triggered`` counts the refits started."""

    def __init__(
        self,
        cfg: M.MCTMConfig,
        scaler: DataScaler,
        k: int,
        seed: int = 0,
        *,
        policy: str = "insertion",
        window: int = 0,
        decay: float = 1.0,
        alpha: float = 0.8,
        chunk_size: int | None = DEFAULT_CHUNK,
        sketch_size: int = 0,
        serve_engine=None,
        detector: DriftDetector | None = None,
        auto_trigger: bool = True,
        refit_kwargs: dict | None = None,
        drift_chunk: int | None = DEFAULT_CHUNK,
        drift_mesh=None,
        drift_axis=None,
        ckpt_dir: str | None = None,
        plan_hook: Callable | None = None,
        device=None,
    ):
        if policy not in STREAM_POLICIES:
            raise ValueError(
                f"unknown stream policy {policy!r} (expected one of {STREAM_POLICIES})")
        if policy == "sliding" and window < 1:
            raise ValueError("sliding policy requires window >= 1")
        if policy == "decayed" and not (0.0 < decay < 1.0):
            raise ValueError("decayed policy requires 0 < decay < 1")
        self.cfg = cfg
        self.scaler = scaler
        self.k = int(k)
        self.policy = policy
        self.window = int(window)
        self.decay = float(decay)
        self.alpha = float(alpha)
        self.sketch_size = int(sketch_size)
        self.seed = int(seed)
        self.plan_hook = plan_hook
        self._buckets: list[_Bucket | None] = []
        self.n_seen = 0
        self.windows_done = 0
        self._moments: tuple | None = None
        self._engine = ScoringEngine(cfg, scaler, chunk_size=chunk_size, device=device)
        self.serve_engine = serve_engine
        self.detector = detector
        self.auto_trigger = bool(auto_trigger)
        self.refit_kwargs = dict(refit_kwargs or {})
        self._drift_chunk = drift_chunk
        self.drift_mesh = drift_mesh
        self.drift_axis = drift_axis
        if drift_mesh is not None and drift_axis is not None:
            drift_mesh.check_axis(drift_axis)
        self.drift_log: list[dict] = []
        self.triggered = 0
        self._mgr = None
        if ckpt_dir is not None:
            from repro_torch.checkpoint import CheckpointManager

            self._mgr = CheckpointManager(str(ckpt_dir), keep=2)

    # ------------------------------------------------------------- reduction

    def _reduce(self, ws: WeightedSet, window: int, stage: int, *,
                update_moments: bool = True) -> WeightedSet:
        """Weighted ℓ2-hull reduction to ≤ k points with the two-round net;
        ``update_moments=False`` keeps the call side-effect-free."""
        out, moments = _weighted_reduce(
            self._engine, ws, self.k, self.alpha, self.sketch_size,
            stage_generator(self.seed, window, stage), _hook_at(self.plan_hook, window, stage),
            two_round=True, moments=self._moments)
        if update_moments and moments is not None:
            self._moments = moments
        return out

    # ------------------------------------------------------------ maintenance

    def live_buckets(self) -> list[_Bucket]:
        return [b for b in self._buckets if b is not None]

    def live_births(self) -> list[int]:
        """Birth windows of the live buckets (eviction observability)."""
        return sorted(b.birth for b in self.live_buckets())

    def total_weight(self) -> float:
        return float(sum(b.w.sum() for b in self.live_buckets()))

    def push(self, chunk: np.ndarray) -> None:
        """Consume one stream window: reduce, maintain buckets per policy,
        checkpoint. The failure-injection point fires before any state
        mutates, so a killed window is simply re-pushed after restore."""
        chunk = np.asarray(chunk)
        widx = self.windows_done
        maybe_inject("streaming", widx + 1)
        fresh = WeightedSet(chunk, np.ones(chunk.shape[0]))

        if self.policy == "sliding":
            bucket_ws = self._reduce(fresh, widx, 0)
            self._buckets.append(_Bucket(bucket_ws.Y, bucket_ws.weights, birth=widx, level=0))
            horizon = widx - self.window
            self._buckets = [b for b in self._buckets if b is not None and b.birth > horizon]
        else:
            if self.policy == "decayed":
                for b in self._buckets:
                    if b is not None:
                        b.w = b.w * self.decay
            carry = self._reduce(fresh, widx, 0)
            level = 0
            while True:
                if level >= len(self._buckets):
                    self._buckets.append(_Bucket(carry.Y, carry.weights, birth=widx, level=level))
                    break
                if self._buckets[level] is None:
                    self._buckets[level] = _Bucket(carry.Y, carry.weights, birth=widx,
                                                   level=level)
                    break
                merged = WeightedSet.concat(self._buckets[level].as_ws(), carry)
                self._buckets[level] = None
                carry = self._reduce(merged, widx, level + 1)
                level += 1

        self.windows_done = widx + 1
        self.n_seen += int(chunk.shape[0])
        if self.detector is not None and self.serve_engine is not None:
            self._observe_window(chunk, widx)
        if self._mgr is not None:
            self._mgr.save(self.windows_done, self.state_dict())

    def result(self) -> WeightedSet:
        """Union of live buckets, reduced once more to ≤ k points;
        idempotent and side-effect-free (its own generator, moments read but
        never written, buckets untouched)."""
        live = self.live_buckets()
        if not live:
            return WeightedSet(np.zeros((0, self.cfg.J)), np.zeros((0,)))
        acc = live[0].as_ws()
        for b in live[1:]:
            acc = WeightedSet.concat(acc, b.as_ws())
        return self._reduce(acc, RESULT_TAG, self.n_seen, update_moments=False)

    # ------------------------------------------------------------ drift loop

    def _observe_window(self, chunk: np.ndarray, widx: int) -> None:
        eng = self.serve_engine
        slot = eng.current_slot()
        nll_pp = drift_window_nll(self.cfg, self.scaler, slot.params, chunk,
                                  chunk=self._drift_chunk, mesh=self.drift_mesh,
                                  axis=self.drift_axis,
                                  device=None if self.drift_mesh is not None
                                  else self._engine.device)
        ref_hint = None
        for rec in reversed(eng.refit_log):
            if rec["version"] == slot.version:
                ref_hint = rec["fit_nll_pp"]
                break
        fired = self.detector.observe(nll_pp, version=slot.version, ref_hint=ref_hint)
        entry = {
            "window": widx,
            "version": int(slot.version),
            "nll_pp": float(nll_pp),
            "ratio": float(self.detector.last_ratio),
            "ewma": float(self.detector.ewma),
            "eps_hat": float(self.detector.eps_hat),
            "fired": bool(fired),
            "triggered": False,
        }
        if fired and self.auto_trigger:
            cs = self.result()
            if cs.size:
                th = eng.start_background_refit(
                    self.scaler, coreset=(cs.Y, np.asarray(cs.weights, np.float32)),
                    generator=stage_generator(self.seed, REFIT_TAG, widx), **self.refit_kwargs)
                if th is not None:
                    self.triggered += 1
                    entry["triggered"] = True
        self.drift_log.append(entry)

    # ---------------------------------------------------------- checkpointing

    def state_dict(self) -> dict[str, np.ndarray]:
        """Flat named-array snapshot of the full maintainer state (the
        reference's names; ragged buckets round-trip through
        ``CheckpointManager.restore_flat``)."""
        out: dict[str, np.ndarray] = {
            "meta": np.asarray([self.windows_done, self.n_seen, len(self._buckets)], np.int64),
            "slots_birth": np.asarray(
                [-1 if b is None else b.birth for b in self._buckets], np.int64),
            "slots_level": np.asarray(
                [-1 if b is None else b.level for b in self._buckets], np.int64),
        }
        for i, b in enumerate(self._buckets):
            if b is not None:
                out[f"b{i:03d}_Y"] = np.asarray(b.Y)
                out[f"b{i:03d}_w"] = np.asarray(b.w)
        if self._moments is not None:
            s1, s2, n_rows = self._moments
            out["mom_s1"] = np.asarray(s1)
            out["mom_s2"] = np.asarray(s2)
            out["mom_n"] = np.asarray(n_rows, np.int64)
        if self.detector is not None:
            out["det"] = self.detector.state()
        return out

    def load_state(self, state: dict[str, np.ndarray]) -> None:
        meta = np.asarray(state["meta"], np.int64)
        self.windows_done = int(meta[0])
        self.n_seen = int(meta[1])
        n_slots = int(meta[2])
        births = np.asarray(state["slots_birth"], np.int64)
        levels = np.asarray(state["slots_level"], np.int64)
        self._buckets = []
        for i in range(n_slots):
            if births[i] < 0:
                self._buckets.append(None)
            else:
                self._buckets.append(_Bucket(np.asarray(state[f"b{i:03d}_Y"]),
                                             np.asarray(state[f"b{i:03d}_w"]),
                                             birth=int(births[i]), level=int(levels[i])))
        if "mom_s1" in state:
            self._moments = (np.asarray(state["mom_s1"]), np.asarray(state["mom_s2"]),
                             int(np.asarray(state["mom_n"])))
        else:
            self._moments = None
        if self.detector is not None and "det" in state:
            self.detector.load(state["det"])

    def resume(self) -> int:
        """Restore the latest window checkpoint from ``ckpt_dir`` (no-op
        without one). Returns the completed windows: the caller re-pushes
        the stream from there and the replay is bit-identical."""
        if self._mgr is None or self._mgr.latest_step() is None:
            return 0
        self.load_state(self._mgr.restore_flat())
        return self.windows_done
