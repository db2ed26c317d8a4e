"""Pass-strategy scoring core for Algorithm 1's pre-sampling phase — the
single-host port of ``repro.core.scoring``.

``ScoringEngine`` streams row chunks of Y through the fused featurize
(``kernels.bernstein``) and scores all n points: leverage u_i of the
flattened basis X̃ (n, J·d) and the directional hull extremes of the
derivative rows P (n·J, d). How often each row is streamed, and what is
carried across chunks, is owned by a pass strategy:

  strategy           sweeps  carry            per-chunk kernels
  TwoPassExact       2       (G, Σp, Σppᵀ)    gram (pass 1); extremes (pass 2)
  TwoPassSketched    2       (SX, Σp, Σppᵀ)   sweep (pass 1); extremes (pass 2)
  OnePassSketched    1       SX               sweep (sketch + z + extremes)

The sweep kernel takes X of any width and P rows of d ≤ 16 (its register
tiling). Wider P rows (a generic featurize's P = X, such as
``data.pipeline.CoresetSelector``'s) are scored beside it (``_sweep_update``):
the chunk's extremes on the extremes kernel's wide body, with chunk-local
ids as the sweep's, and the moments (Σp, Σppᵀ) on the gram kernel
(``_gram_moments``).

The strategy contract is the reference's: ``init_state`` / ``update`` /
``fused_update`` / ``gram`` / ``result_gram`` / ``moments``; the chunk loop,
running extremes and ``ScoringResult`` assembly live once in the engine. The
between-pass algebra (eigh of the (Jd)² Gram, the direction net) is host
float64 numpy, as in the reference.

Random plans are inputs: torch cannot reproduce ``jax.random``, so the
CountSketch rows/signs (and Ω) come in as ``plan=`` and the hull net's
normal draws as ``hull_normals=`` (or the whole net as ``hull_dirs=``);
without them they are drawn from ``generator``.

``gram_dtype="float64"`` carries the accumulator in float64, as the
reference does: ``TwoPassExact`` adds each chunk's (√w·X)ᵀ(√w·X) as a
float64 product (the gram kernel is float32 only; the reference forms this
product outside its Pallas kernel too), and the sketched strategies carry
SX in float64 through ``countsketch_add`` — an explicit path of this
module, in a fixed order (each bucket's rows added in ascending row order
from the carry, no ``index_add_``), since the sweep kernel is float32 only.
Their moments, z rows and extremes stay float32, as in the reference.

``sweep_ckpt=`` (a directory) checkpoints each sweep's carry every ``ft``
config ``sweep_ckpt_every_chunks`` chunks with its chunk cursor
(``_SweepCheckpoints``: ``sweep1/``, ``sweep2/``), and ``resume=True``
restarts a crashed sweep from its cursor; the result is the uninterrupted
sweep's, bit for bit. The random plans drawn from ``generator`` are part of
that: a checkpoint of the generator's state at entry (``entry/``, written
before any draw) is restored by a resume before it draws, so a resumed call
draws the same plan and net and leaves the generator where the
uninterrupted call would. Without
``sweep_ckpt`` the loop is the plain one (no probe featurize, no added
host read); both call ``ft.maybe_inject("scoring", …)`` after each chunk.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from repro_torch.core.hull import hull_directions, stable_first_unique
from repro_torch.device import resolve_device, to_tensor
from repro_torch.ft.config import get_ft_config, maybe_inject
from repro_torch.kernels.bernstein import bernstein_featurize
from repro_torch.kernels.extremes import directional_extremes
from repro_torch.kernels.gram import gram_matrix
from repro_torch.kernels.sweep import fused_sweep_update
from repro_torch.kernels.sweep.ops import MAX_DP as SWEEP_MAX_DP

__all__ = [
    "ScoringEngine",
    "ScoringResult",
    "score_chunks",
    "PassStrategy",
    "TwoPassExact",
    "TwoPassSketched",
    "OnePassSketched",
    "resolve_strategy",
    "sketch_plan",
    "upfront_directions",
    "RunningExtremes",
    "pass1_update",
    "leverage_chunk",
    "hull_chunk_extremes",
    "projection_from_gram",
    "gram_projection",
    "directions_from_moments",
    "finalize_scoring",
    "countsketch_add",
    "DEFAULT_CHUNK",
    "SCORE_METHODS",
]

DEFAULT_CHUNK = 65_536

SCORE_METHODS = ("l2-only", "l2-hull", "ridge-lss", "root-l2")
GRAM_DTYPES = ("float32", "float64")


def _check_gram_dtype(gram_dtype: str) -> None:
    if gram_dtype not in GRAM_DTYPES:
        raise ValueError(f"gram_dtype must be one of {GRAM_DTYPES}")


def _spectrum_inverse(w: np.ndarray, *, ridge_reg: float, rcond: float) -> np.ndarray:
    """Inverted eigenvalue weights of the leverage projection."""
    if ridge_reg > 0.0:
        return 1.0 / (np.maximum(w, 0.0) + ridge_reg)
    wmax = np.max(np.abs(w))
    return np.where(w > rcond * wmax, 1.0 / np.maximum(w, 1e-30), 0.0)


@dataclasses.dataclass
class ScoringResult:
    """Everything the sampling step of Algorithm 1 needs, for n points."""

    scores: np.ndarray             # (n,) sampling scores s_i
    leverage: np.ndarray           # (n,) raw leverage-type scores u_i
    gram: np.ndarray               # (D, D) accumulated (possibly sketched) Gram
    hull_rows: np.ndarray | None   # ordered extremal row ids into the (n·r) P rows
    hull_points: np.ndarray | None  # unique point ids hit by hull_rows (sorted)
    n: int
    n_chunks: int
    rows_per_point: int = 1
    moments: tuple | None = None   # (s1, s2, n_rows) when the strategy tracked them

    @property
    def hull_candidates(self) -> np.ndarray | None:
        return self.hull_rows


def _mctm_featurize(cfg, scaler) -> Callable[[torch.Tensor], tuple]:
    """Fused basis + derivative evaluation of one chunk of Y on the bernstein
    kernel: (X̃ (c, J·d), P (c·J, d)), the math of ``mctm.basis_features``."""
    bounds: dict = {}  # the scaler as a (3, J) tensor, once per device

    def featurize(Yc: torch.Tensor):
        b = bounds.get(Yc.device)
        if b is None:
            b = bounds[Yc.device] = scaler.bounds(torch.float32, Yc.device)
        A, Ap = bernstein_featurize(Yc.contiguous(), b, cfg.degree)
        c = A.shape[0]
        return A.reshape(c, cfg.J * cfg.d), Ap.reshape(c * cfg.J, cfg.d)

    return featurize


# --------------------------------------------------------------------------
# per-chunk steps
# --------------------------------------------------------------------------


def pass1_update(G, s1, s2, X, P, sw):
    """Pass-1 accumulation: Gram of √w-scaled rows added to G (gram kernel,
    √w and the add fused) plus the P first/second moments (``P is None``
    skips them)."""
    G = gram_matrix(X, sw, acc=G)
    if P is not None:
        s1, s2 = _moments_update(s1, s2, P)
    return G, s1, s2


def leverage_chunk(X, sw, V, inv):
    """u_i = Σ_m ((√w·X)_i V)²_m · inv_m for one chunk of rows."""
    return _z_leverage(X * sw[:, None], V, inv)


def hull_chunk_extremes(P, dirs, n_valid: int | None = None):
    """Per-chunk (max, argmax, min, argmin) per direction (extremes kernel);
    rows at or past ``n_valid`` are never extreme."""
    return directional_extremes(P, dirs, n_valid)


def _moments_update(s1, s2, P):
    return s1 + torch.sum(P, dim=0), s2 + P.T @ P


def _gram_moments(s1, s2, P):
    """(s1 + Σp, s2 + Σppᵀ) in one gram-kernel call: the Gram of the rows
    [p, 1] with the carry [[s2, s1], [s1ᵀ, 0]] as its accumulator."""
    d = P.shape[1]
    ones = torch.ones((P.shape[0], 1), dtype=torch.float32, device=P.device)
    acc = torch.zeros((d + 1, d + 1), dtype=torch.float32, device=P.device)
    acc[:d, :d] = s2
    acc[:d, d] = s1
    acc[d, :d] = s1
    G = gram_matrix(torch.cat([P, ones], dim=1), acc=acc)
    return G[:d, d].contiguous(), G[:d, :d].contiguous()


def _sweep_update(SX, X, P, sw, rows, signs, *, dirs=None, omega=None, moments=None,
                  want_z=True):
    """``fused_sweep_update`` for P rows of any d: up to the kernel's
    SWEEP_MAX_DP the sweep takes P (extremes and moments in its own body);
    a wider P is scored beside it, its chunk extremes on the extremes
    kernel (chunk-local ids, as the sweep's) and its moments on the gram
    kernel (``_gram_moments``). Returns ``(SX', z, ext, moments')``."""
    if P is None or P.shape[1] <= SWEEP_MAX_DP:
        return fused_sweep_update(SX, X, P, sw, rows, signs, dirs=dirs, omega=omega,
                                  moments=moments, want_z=want_z)
    SX, z, _, _ = fused_sweep_update(SX, X, None, sw, rows, signs, omega=omega, want_z=want_z)
    ext = hull_chunk_extremes(P, dirs) if dirs is not None else None
    mom = _gram_moments(*moments, P) if moments is not None else None
    return SX, z, ext, mom


def _sketch_update(SX, s1, s2, X, P, sw, rows, signs):
    """Unfused CountSketch accumulation SX += S·(√w·X) — the formulation the
    fused sweep replaces, kept as the tests' cross-check."""
    SX = SX.index_add(0, rows.long(), signs[:, None] * (X * sw[:, None]))
    if P is not None:
        s1, s2 = _moments_update(s1, s2, P)
    return SX, s1, s2


def countsketch_add(SX: torch.Tensor, V: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """SX + S·V in SX's dtype, S the CountSketch that adds row i of V (signs
    already applied) into bucket rows[i]: a new tensor. Each bucket's rows
    are added in ascending row order from the carry, as the reference's
    sequential scatter-add and the sweep kernel add them, without atomics:
    the rows are ranked within their bucket, and rank by rank every bucket
    takes at most one row (an index write with unique indices). One host
    read a call (the rank sizes)."""
    c = int(rows.shape[0])
    out = SX.clone()
    if c == 0:
        return out
    rows = rows.long()
    order = torch.argsort(rows, stable=True)
    sorted_rows = rows[order]
    counts = torch.bincount(sorted_rows, minlength=SX.shape[0])
    rank = torch.arange(c, device=rows.device) - (torch.cumsum(counts, 0) - counts)[sorted_rows]
    by_rank = order[torch.argsort(rank, stable=True)]
    V = V.to(SX.dtype)
    lo = 0
    for size in torch.bincount(rank).tolist():
        e = by_rank[lo:lo + size]
        r = rows[e]
        out[r] = out[r] + V[e]
        lo += size
    return out


def _weighted_project(X, sw, omega):
    """z = (√w·X)Ω (Ω None → √w·X), the unfused one-pass emission."""
    Xw = X * sw[:, None]
    return Xw if omega is None else Xw @ omega


def _z_leverage(z, V, inv):
    """Leverage read off stored (already √w-scaled) row blocks."""
    return torch.sum(torch.square(z @ V) * inv, dim=1)


def sketch_plan(n: int, sketch_size: int, *, generator: torch.Generator | None = None,
                device=None):
    """CountSketch rows (n,) int32 in [0, sketch_size) and ±1 signs (n,) f32."""
    rows = torch.randint(0, sketch_size, (n,), generator=generator, dtype=torch.int64)
    signs = torch.randint(0, 2, (n,), generator=generator, dtype=torch.int64) * 2 - 1
    return rows.to(device=device, dtype=torch.int32), signs.to(device=device, dtype=torch.float32)


# --------------------------------------------------------------------------
# between-pass host algebra
# --------------------------------------------------------------------------


def gram_projection(G, *, ridge_reg: float = 0.0, rcond: float = 1e-6, device=None):
    """Factor G into (V, inv) with u_i = Σ_m (X_i V)²_m · inv_m: ``ridge_reg
    == 0`` gives the pseudo-inverse's leverage, ``ridge_reg > 0`` ridge
    leverage u_i(λ) = X_i (G + λI)⁻¹ X_iᵀ through the same eigenbasis. The
    reference's ``gram_projection``; its eigh runs on the host in float64
    here (as the port's leverage eigh does), returned as f32 tensors on
    ``device`` (G's device when None)."""
    dev = G.device if device is None and isinstance(G, torch.Tensor) else device
    w, V = np.linalg.eigh(np.asarray(_to_np(G), np.float64))
    inv = _spectrum_inverse(w, ridge_reg=ridge_reg, rcond=rcond)
    f32 = dict(dtype=torch.float32, device=dev)
    return torch.as_tensor(V, **f32), torch.as_tensor(inv, **f32)


def projection_from_gram(G, method: str, ridge_reg: float, rcond: float = 1e-6, device=None):
    """(V, inv) of a scoring method from a float64 host eigh of the (D, D)
    Gram (``gram_projection``; the ridge applies to ``ridge-lss`` only)."""
    reg = ridge_reg if method == "ridge-lss" else 0.0
    return gram_projection(G, ridge_reg=reg, rcond=rcond, device=device)


def _to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def directions_from_moments(
    s1, s2, n_rows: int, hull_k: int, oversample: int = 4, *,
    normals=None, generator: torch.Generator | None = None,
) -> np.ndarray:
    """Direction net from accumulated P moments (cov = E[ppᵀ] − μμᵀ)."""
    s1 = np.asarray(_to_np(s1), np.float64)
    s2 = np.asarray(_to_np(s2), np.float64)
    mu = s1 / max(n_rows, 1)
    cov = s2 / max(n_rows, 1) - np.outer(mu, mu)
    m = max(oversample * hull_k, 8)
    return hull_directions(cov, m, normals=normals, generator=generator).astype(np.float32)


def upfront_directions(
    p: int, hull_k: int, oversample: int = 4, *,
    normals=None, generator: torch.Generator | None = None,
) -> np.ndarray:
    """One-pass direction net, built before any data: the same construction
    with an identity covariance prior (±coordinate axes)."""
    m = max(oversample * hull_k, 8)
    return hull_directions(np.eye(p), m, normals=normals, generator=generator).astype(np.float32)


class RunningExtremes:
    """Host-side running (max, argmax, min, argmin) per direction across
    chunks; strict comparisons keep the first occurrence (lowest row)."""

    def __init__(self, m: int):
        self.best_max = np.full(m, -np.inf, np.float32)
        self.best_min = np.full(m, np.inf, np.float32)
        self.best_imax = np.zeros(m, np.int64)
        self.best_imin = np.zeros(m, np.int64)

    def update(self, vmax, imax, vmin, imin, offset: int) -> None:
        vmax, imax = _to_np(vmax), _to_np(imax).astype(np.int64) + offset
        vmin, imin = _to_np(vmin), _to_np(imin).astype(np.int64) + offset
        upd = vmax > self.best_max
        self.best_max[upd], self.best_imax[upd] = vmax[upd], imax[upd]
        upd = vmin < self.best_min
        self.best_min[upd], self.best_imin[upd] = vmin[upd], imin[upd]

    def candidates(self) -> np.ndarray:
        """ALL distinct extremal row ids, first-occurrence order (≤ 2m)."""
        return stable_first_unique(np.concatenate([self.best_imax, self.best_imin]))

    def state(self) -> dict[str, np.ndarray]:
        """Checkpointable snapshot (f32/int64 arrays: an exact round trip)."""
        return {
            "max": self.best_max.copy(),
            "imax": self.best_imax.copy(),
            "min": self.best_min.copy(),
            "imin": self.best_imin.copy(),
        }

    def load(self, s) -> None:
        self.best_max = np.asarray(s["max"], np.float32).copy()
        self.best_imax = np.asarray(s["imax"], np.int64).copy()
        self.best_min = np.asarray(s["min"], np.float32).copy()
        self.best_imin = np.asarray(s["imin"], np.int64).copy()


def finalize_scoring(
    n: int, n_chunks: int, method: str, G, u, hull_rows, rows_per_point: int,
    moments: tuple | None = None,
) -> ScoringResult:
    """Assemble a ``ScoringResult`` from raw leverage + hull candidates."""
    u = _to_np(u)
    lev = np.sqrt(np.clip(u, 0.0, None)) if method == "root-l2" else u
    scores = lev + 1.0 / n
    hull_points = None if hull_rows is None else np.unique(hull_rows // rows_per_point)
    return ScoringResult(
        scores=scores, leverage=lev, gram=_to_np(G), hull_rows=hull_rows,
        hull_points=hull_points, n=n, n_chunks=n_chunks,
        rows_per_point=rows_per_point, moments=moments,
    )


# --------------------------------------------------------------------------
# pass strategies
# --------------------------------------------------------------------------


class PassStrategy:
    """Base contract (see the module doc). ``begin`` returns the per-call
    plan: the given ``plan`` moved to the device, or fresh draws."""

    one_pass = False
    needs_key = False
    n_data_passes = 2

    def begin(self, n: int, D: int, generator, plan, device):
        return None

    def slice_plan(self, plan, lo: int, hi: int) -> tuple:
        return ()

    def moments(self, state):
        return state[1], state[2]

    def result_gram(self, state, plan=None):
        return self.gram(state, plan)

    def fused_update(self, state, X, P, sw, plan_slice=(), dirs=None):
        """Per-chunk accumulation plus the chunk-local extremes against
        ``dirs`` (``None`` without dirs): ``update`` then the extremes kernel."""
        state, z = self.update(state, X, P, sw, plan_slice)
        ext = hull_chunk_extremes(P, dirs) if dirs is not None else None
        return state, z, ext


def _moment_state(p, device):
    f32 = dict(dtype=torch.float32, device=device)
    return torch.zeros((p,), **f32), torch.zeros((p, p), **f32)


def _acc_dtype(gram_dtype: str) -> torch.dtype:
    return torch.float64 if gram_dtype == "float64" else torch.float32


@dataclasses.dataclass(frozen=True)
class TwoPassExact(PassStrategy):
    """Exact Gram in pass 1 — float32 on the gram kernel, or float64 as a
    float64 product (``gram_dtype="float64"``, moments still float32);
    pass 2 re-streams the chunks for leverage and the extremes."""

    gram_dtype: str = "float32"

    def __post_init__(self):
        _check_gram_dtype(self.gram_dtype)

    def init_state(self, D: int, p: int | None, device):
        G = torch.zeros((D, D), dtype=_acc_dtype(self.gram_dtype), device=device)
        if p is None:
            return (G, None, None)
        return (G, *_moment_state(p, device))

    def update(self, state, X, P, sw, plan_slice=()):
        if self.gram_dtype == "float64":
            G, s1, s2 = state
            Xw = (X * sw[:, None]).to(torch.float64)
            G = G + Xw.T @ Xw
            if P is not None:
                s1, s2 = _moments_update(s1, s2, P)
            return (G, s1, s2), None
        return pass1_update(*state, X, P, sw), None

    def gram(self, state, plan=None):
        return state[0]


@dataclasses.dataclass(frozen=True)
class _SketchedBase(PassStrategy):
    """Shared CountSketch plan/state of the sketched strategies. With
    ``gram_dtype="float64"`` SX is carried in float64 through
    ``_f64_update`` (see the module doc)."""

    sketch_size: int = 0
    gram_dtype: str = "float32"

    needs_key = True

    def __post_init__(self):
        if self.sketch_size <= 0:
            raise ValueError("sketched strategies require sketch_size > 0")
        _check_gram_dtype(self.gram_dtype)

    def _plan_rows(self, n, generator, plan, device):
        if plan is None:
            return sketch_plan(n, self.sketch_size, generator=generator, device=device)
        rows = to_tensor(plan[0], device=device).to(torch.int32)
        signs = to_tensor(plan[1], torch.float32, device)
        if rows.shape != (n,) or signs.shape != (n,):
            raise ValueError(f"plan rows/signs must be ({n},)")
        if int(rows.min()) < 0 or int(rows.max()) >= self.sketch_size:
            raise ValueError(f"plan rows must lie in [0, {self.sketch_size})")
        return rows, signs

    def begin(self, n: int, D: int, generator, plan, device):
        return self._plan_rows(n, generator, plan, device)

    def slice_plan(self, plan, lo: int, hi: int) -> tuple:
        return (plan[0][lo:hi], plan[1][lo:hi])

    def init_state(self, D: int, p: int | None, device):
        SX = torch.zeros((self.sketch_size, D), dtype=_acc_dtype(self.gram_dtype), device=device)
        if p is None:
            return (SX, None, None)
        return (SX, *_moment_state(p, device))

    def gram(self, state, plan=None):
        return state[0].T @ state[0]

    def _f64_update(self, state, X, P, sw, rows, signs, *, dirs=None, omega=None,
                    want_z=False):
        """The float64-sketch step, unfused: SX += S·(√w·X) in float64
        (``countsketch_add``), the moments when carried, z = (√w·X)Ω in
        float32 when ``want_z``, and the extremes against ``dirs`` on the
        extremes kernel. Returns ``(state, z, ext)``."""
        Xw = X * sw[:, None]
        SX = countsketch_add(state[0], signs[:, None] * Xw, rows)
        s1, s2 = state[1], state[2]
        if s1 is not None and P is not None:
            s1, s2 = _moments_update(s1, s2, P)
        z = (Xw if omega is None else Xw @ omega) if want_z else None
        ext = hull_chunk_extremes(P, dirs) if dirs is not None else None
        return (SX, s1, s2), z, ext


@dataclasses.dataclass(frozen=True)
class TwoPassSketched(_SketchedBase):
    """CountSketch Gram in pass 1 through the fused sweep (sketch + moments,
    nothing retained); pass 2 re-streams as ``TwoPassExact`` does."""

    def update(self, state, X, P, sw, plan_slice=()):
        rows, signs = plan_slice
        if self.gram_dtype == "float64":
            return self._f64_update(state, X, P, sw, rows, signs)[0], None
        moments = (state[1], state[2]) if P is not None else None
        SX, _, _, mom = _sweep_update(
            state[0], X, P, sw, rows, signs, moments=moments, want_z=False
        )
        s1, s2 = mom if mom is not None else (state[1], state[2])
        return (SX, s1, s2), None


@dataclasses.dataclass(frozen=True)
class OnePassSketched(_SketchedBase):
    """True one-pass sketched scoring: one sweep accumulates SX, tracks the
    extremes against the upfront net and emits z = (√w·X)Ω, from which
    leverage is read off. ``proj_size=q < D`` projects the retained rows
    through a Gaussian Ω (D, q) / √q; ``track_moments`` also accumulates
    (Σp, Σppᵀ) for a later block's net."""

    proj_size: int | None = None
    track_moments: bool = False

    one_pass = True
    n_data_passes = 1

    def begin(self, n: int, D: int, generator, plan, device):
        rows, signs = self._plan_rows(n, generator, plan, device)
        omega = None
        if self.proj_size is not None and self.proj_size < D:
            if plan is not None and len(plan) > 2 and plan[2] is not None:
                omega = to_tensor(plan[2], torch.float32, device)
                if omega.shape != (D, self.proj_size):
                    raise ValueError(f"plan omega must be ({D}, {self.proj_size})")
            else:
                omega = (
                    torch.randn((D, self.proj_size), generator=generator, dtype=torch.float32)
                    / np.sqrt(self.proj_size)
                ).to(device)
        return (rows, signs, omega)

    def slice_plan(self, plan, lo: int, hi: int) -> tuple:
        return (plan[0][lo:hi], plan[1][lo:hi], plan[2])

    def init_state(self, D: int, p: int | None, device):
        SX = torch.zeros((self.sketch_size, D), dtype=_acc_dtype(self.gram_dtype), device=device)
        if self.track_moments and p is not None:
            return (SX, *_moment_state(p, device))
        return (SX, None, None)

    def update(self, state, X, P, sw, plan_slice=()):
        state, z, _ = self.fused_update(state, X, P, sw, plan_slice)
        return state, z

    def fused_update(self, state, X, P, sw, plan_slice=(), dirs=None):
        """CountSketch + z + extremes (+ moments) in one sweep-kernel call;
        ``ext`` carries chunk-local row ids."""
        rows, signs, omega = plan_slice
        if self.gram_dtype == "float64":
            return self._f64_update(state, X, P, sw, rows, signs, dirs=dirs, omega=omega,
                                    want_z=True)
        moments = (state[1], state[2]) if state[1] is not None and P is not None else None
        keep_P = dirs is not None or moments is not None
        SX, z, ext, mom = _sweep_update(
            state[0], X, P if keep_P else None, sw, rows, signs,
            dirs=dirs, omega=omega, moments=moments,
        )
        s1, s2 = mom if mom is not None else (state[1], state[2])
        return (SX, s1, s2), z, ext

    def gram(self, state, plan=None):
        """Projection Gram (SXΩ)ᵀ(SXΩ), the Gram of the retained z rows."""
        SX = state[0]
        if plan is not None and plan[2] is not None:
            SX = SX @ plan[2].to(SX.dtype)
        return SX.T @ SX

    def result_gram(self, state, plan=None):
        return state[0].T @ state[0]


_STRATEGY_NAMES = ("two-pass", "two-pass-sketched", "one-pass")


def resolve_strategy(strategy, *, sketch_size: int = 0, gram_dtype: str = "float32") -> PassStrategy:
    """``None`` decides from ``sketch_size`` (exact two-pass without a
    sketch, one-pass with one); names select the built-ins; instances pass
    through."""
    if isinstance(strategy, PassStrategy):
        return strategy
    if strategy is None:
        if sketch_size > 0:
            return OnePassSketched(sketch_size, gram_dtype)
        return TwoPassExact(gram_dtype)
    if strategy == "two-pass":
        return TwoPassExact(gram_dtype)
    if strategy == "two-pass-sketched":
        return TwoPassSketched(sketch_size, gram_dtype)
    if strategy == "one-pass":
        return OnePassSketched(sketch_size, gram_dtype)
    raise ValueError(
        f"unknown pass strategy {strategy!r} (expected one of {_STRATEGY_NAMES} "
        "or a PassStrategy instance)"
    )


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


class _SweepCheckpoints:
    """Per-sweep ``CheckpointManager`` pair for resumable chunk scans.

    ``root`` is a directory (or anything with a ``directory`` attribute);
    sweeps 1 and 2 get separate subdirectories so their cursors cannot
    shadow each other, and ``entry/`` holds the generator's state at the
    call's entry. Cadence comes from the ``ft`` config."""

    def __init__(self, root):
        from repro_torch.checkpoint import CheckpointManager

        if not isinstance(root, (str, os.PathLike)):
            root = getattr(root, "directory")
        self.every = max(int(get_ft_config().sweep_ckpt_every_chunks), 1)
        self.mgr0 = CheckpointManager(os.path.join(str(root), "entry"), keep=1)
        self.mgr1 = CheckpointManager(os.path.join(str(root), "sweep1"), keep=2)
        self.mgr2 = CheckpointManager(os.path.join(str(root), "sweep2"), keep=2)


class ScoringEngine:
    """Drives the pre-sampling phase of Algorithm 1 in O(chunk) memory (the
    one-pass strategy also retains its z rows).

    cfg, scaler: the MCTM config and data scaler (default featurize: the
        bernstein kernel). featurize: optional override ``Y_chunk → (X (c, D),
        P or None)``. chunk_size: rows per chunk; one chunk → the dense fast
        path (one featurize shared by both sweeps); None/0 → never chunk.
    device: where the sweeps run (None → CUDA, which must exist).
    """

    def __init__(
        self,
        cfg=None,
        scaler=None,
        *,
        featurize: Callable | None = None,
        chunk_size: int | None = DEFAULT_CHUNK,
        rows_per_point: int | None = None,
        hull_oversample: int = 4,
        gram_dtype: str = "float32",
        device=None,
    ):
        self.device = resolve_device(device)
        if featurize is None:
            if cfg is None or scaler is None:
                raise ValueError("either (cfg, scaler) or featurize is required")
            featurize = _mctm_featurize(cfg, scaler)
            rows_per_point = cfg.J
        _check_gram_dtype(gram_dtype)
        self.cfg = cfg
        self.scaler = scaler
        self.featurize = featurize
        self.chunk_size = int(chunk_size) if chunk_size else 0
        self.rows_per_point = int(rows_per_point or 1)
        self.hull_oversample = hull_oversample
        self.gram_dtype = gram_dtype

    def score(
        self,
        Y,
        *,
        method: str = "l2-hull",
        weights=None,
        generator: torch.Generator | None = None,
        sketch_size: int = 0,
        ridge_reg: float = 1.0,
        hull_k: int = 0,
        hull_normals=None,
        hull_dirs=None,
        strategy=None,
        gram_dtype: str | None = None,
        plan=None,
        sweep_ckpt=None,
        resume: bool = False,
    ) -> ScoringResult:
        """Score all n points (and select hull candidates when hull_k > 0).

        ``plan``: the sketched strategies' CountSketch ``(rows, signs)`` or
        ``(rows, signs, omega)``; ``hull_normals`` (m, p): the direction
        net's normal draws; ``hull_dirs`` (m', p): the whole net, overriding
        it. What is not given is drawn from ``generator``.

        ``sweep_ckpt`` (a directory) saves the generator's state at entry and
        each sweep's carry — strategy state, running extremes, the retained
        z rows or emitted leverage, the chunk cursor — every
        ``sweep_ckpt_every_chunks`` chunks; with ``resume=True`` a crashed
        sweep restarts from its cursor and the result is bit-identical to
        the uninterrupted sweep's (module doc).
        """
        Y = to_tensor(Y, torch.float32, self.device)
        n = int(Y.shape[0])
        strat = self._strategy(method, n, generator, sketch_size, hull_k, hull_normals,
                               hull_dirs, strategy, gram_dtype, plan)
        sqrt_w = None
        if weights is not None:
            sqrt_w = torch.sqrt(to_tensor(weights, torch.float32, self.device))
        chunk = self.chunk_size if self.chunk_size > 0 else n
        return self._drive(
            strat, generator, plan, Y, sqrt_w, n, chunk, method, ridge_reg, hull_k,
            hull_normals, hull_dirs, sweep_ckpt=sweep_ckpt, resume=resume,
        )

    def _strategy(self, method, n, generator, sketch_size, hull_k, hull_normals, hull_dirs,
                  strategy, gram_dtype, plan) -> PassStrategy:
        """The checks of a ``score`` call; returns its pass strategy."""
        if method not in SCORE_METHODS:
            raise ValueError(f"unknown scoring method: {method}")
        if n == 0:
            raise ValueError("cannot score an empty dataset")
        if hull_k > 0 and hull_normals is None and hull_dirs is None and generator is None:
            raise ValueError("hull_k > 0 requires generator, hull_normals or hull_dirs")
        if hull_dirs is not None and hull_k <= 0:
            raise ValueError("hull_dirs requires hull_k > 0")
        strat = resolve_strategy(
            strategy, sketch_size=sketch_size, gram_dtype=gram_dtype or self.gram_dtype
        )
        if strat.needs_key and plan is None and generator is None:
            raise ValueError("sketch_size > 0 requires generator or plan")
        return strat

    def _net(self, build, hull_normals, hull_dirs, generator):
        if hull_dirs is not None:
            return to_tensor(hull_dirs, torch.float32, self.device)
        return torch.as_tensor(build(normals=hull_normals, generator=generator),
                               device=self.device)

    def _drive(self, strat, generator, plan_in, Y, sqrt_w, n, chunk, method, ridge_reg,
               hull_k, hull_normals, hull_dirs, sweep_ckpt=None, resume=False,
               shard=None) -> ScoringResult:
        """The shared chunk loop. Sweep 1 streams every chunk through
        ``strat.fused_update`` (one-pass: with the extremes against the
        upfront net). Two-pass strategies re-stream for leverage and the
        extremes against the moment net; one-pass reads leverage off the
        retained z rows.

        With ``sweep_ckpt`` each sweep's carry is a fixed-shape payload saved
        every N chunks with its cursor, and ``resume`` skips the chunks the
        cursor covers. Only this path pays a shape-probing featurize of chunk
        0, keeps the z rows in one (n, width) buffer and reads the carry to
        the host at each save; the between-sweep algebra is recomputed from
        the restored carry.

        ``shard`` (a ``distributed_coreset._Shard``) runs the loop as one
        rank of a mesh: ``Y`` holds the rank's rows, its chunk ``ranges``
        (empty ones included, so every rank counts the same chunks) sit at
        global row ``base``, the plans are drawn for the global n and
        sliced by global row, the strategy state is folded once after sweep
        1, and the extremes and the leverage are gathered at the end."""
        featurize = self.featurize
        dev = self.device
        r = self.rows_per_point
        want_hull = hull_k > 0
        want_P = want_hull or getattr(strat, "track_moments", False)
        if shard is None:
            ranges = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
            base, n_all = 0, n
        else:
            ranges, base, n_all = shard.ranges, shard.base, shard.n
        n_chunks = len(ranges)

        def _prep(lo, hi):
            Xc, Pc = featurize(Y[lo:hi])
            if want_hull and Pc is None:
                raise ValueError("hull_k > 0 requires a featurize that returns P rows")
            if not want_P:
                Pc = None
            swc = sqrt_w[lo:hi] if sqrt_w is not None else torch.ones(hi - lo, device=dev)
            return Xc, Pc, swc

        cached: dict = {}

        def get_chunk(lo, hi):
            if n_chunks > 1:
                return _prep(lo, hi)
            if not cached:  # dense fast path: featurize once for both sweeps
                cached["c"] = _prep(lo, hi)
            return cached["c"]

        def shapes():
            """(D, p) of the featurize: from the first chunk, or from the
            mesh's probe row on a rank that holds no rows."""
            rows = [rg for rg in ranges if rg[1] > rg[0]]
            if rows:
                Xc, Pc, _ = get_chunk(*rows[0])
            else:
                Xc, Pc = featurize(shard.probe)
                Pc = Pc if want_P else None
            return int(Xc.shape[1]), (int(Pc.shape[1]) if Pc is not None else None)

        def begin(D, p):
            plan = strat.begin(n_all, D, generator, plan_in, dev)
            state = strat.init_state(D, p, dev)
            dirs1 = ext = None
            if strat.one_pass and want_hull:
                dirs1 = self._net(
                    lambda **kw: upfront_directions(p, hull_k, self.hull_oversample, **kw),
                    hull_normals, hull_dirs, generator,
                )
                ext = RunningExtremes(int(dirs1.shape[0]))
            return plan, state, dirs1, ext

        # ---- sweep 1
        state = plan = None
        z_blocks: list = []
        z_buf = None
        ext = dirs1 = None
        ck = _SweepCheckpoints(sweep_ckpt) if sweep_ckpt is not None else None
        done1 = 0
        if ck is not None:
            if generator is not None:  # a resume draws the plans from the entry state
                if resume and ck.mgr0.latest_step() is not None:
                    generator.set_state(torch.from_numpy(ck.mgr0.restore_flat()["gen"]))
                else:
                    ck.mgr0.save(0, {"gen": generator.get_state().numpy()})
            # fixed-shape payloads need (D, p) before the loop: probe chunk 0
            D, p = shapes()
            plan, state, dirs1, ext = begin(D, p)
            if strat.one_pass:
                width = D if plan[2] is None else int(plan[2].shape[1])
                z_buf = torch.zeros((n, width), dtype=torch.float32, device=dev)

            def payload1():
                out = {"chunks": np.int64(done1), "state": state}
                if z_buf is not None:
                    out["z"] = z_buf
                if ext is not None:
                    out["ext"] = ext.state()
                return out

            if resume and ck.mgr1.latest_step() is not None:
                got = ck.mgr1.restore(payload1())
                done1 = int(got["chunks"])
                state = got["state"]
                if z_buf is not None:
                    z_buf = got["z"]
                if ext is not None:
                    ext.load(got["ext"])

        for ci, (lo, hi) in enumerate(ranges):
            if ci < done1:
                continue
            if hi > lo:
                Xc, Pc, swc = get_chunk(lo, hi)
                if state is None:
                    plan, state, dirs1, ext = begin(int(Xc.shape[1]),
                                                    int(Pc.shape[1]) if Pc is not None else None)
                state, z, extb = strat.fused_update(
                    state, Xc, Pc, swc, strat.slice_plan(plan, base + lo, base + hi), dirs=dirs1
                )
                if z is not None:
                    if z_buf is not None:
                        z_buf[lo:hi] = z
                    else:
                        z_blocks.append(z)
                if ext is not None:
                    ext.update(*extb, offset=(base + lo) * r)
            if ck is not None and ((ci + 1) % ck.every == 0 or ci + 1 == n_chunks):
                done1 = ci + 1
                ck.mgr1.save(ci + 1, payload1())
            maybe_inject("scoring", ci + 1)
        if state is None:  # a rank that holds no rows still takes the draws
            plan, state, dirs1, ext = begin(*shapes())
        if shard is not None:  # one collective: the per-rank partials, summed in rank order
            state = tuple(shard.mesh.fold(state))

        # ---- between sweeps: (Jd)²-scale host algebra
        V, inv = projection_from_gram(strat.gram(state, plan), method, ridge_reg, device=dev)

        hull_rows = None
        if strat.one_pass:
            if z_buf is not None:
                # fresh chunk-sized blocks, as the plain path's, for its bits
                z_blocks = [z_buf[lo:hi].clone() for lo, hi in ranges if hi > lo]
            u = (torch.cat([_z_leverage(z, V, inv) for z in z_blocks]) if z_blocks
                 else torch.zeros(0, dtype=torch.float32, device=dev))
        else:
            # ---- sweep 2: leverage + directional extremes
            if want_hull:
                s1, s2 = strat.moments(state)
                dirs = self._net(
                    lambda **kw: directions_from_moments(
                        s1, s2, n_all * r, hull_k, self.hull_oversample, **kw),
                    hull_normals, hull_dirs, generator,
                )
                ext = RunningExtremes(int(dirs.shape[0]))
            u = torch.empty(n, dtype=torch.float32, device=dev)
            done2 = 0
            if ck is not None:

                def payload2():
                    out = {"chunks": np.int64(done2), "u": u}
                    if ext is not None:
                        out["ext"] = ext.state()
                    return out

                if resume and ck.mgr2.latest_step() is not None:
                    got = ck.mgr2.restore(payload2())
                    done2 = int(got["chunks"])
                    u = got["u"]
                    if ext is not None:
                        ext.load(got["ext"])
            for ci, (lo, hi) in enumerate(ranges):
                if ci < done2:
                    continue
                if hi > lo:
                    Xc, Pc, swc = get_chunk(lo, hi)
                    u[lo:hi] = leverage_chunk(Xc, swc, V, inv)
                    if ext is not None:
                        ext.update(*hull_chunk_extremes(Pc, dirs), offset=(base + lo) * r)
                if ck is not None and ((ci + 1) % ck.every == 0 or ci + 1 == n_chunks):
                    done2 = ci + 1
                    ck.mgr2.save(ci + 1, payload2())
                maybe_inject("scoring", n_chunks + ci + 1)
        if ext is not None:
            hull_rows = ext.candidates() if shard is None else shard.hull_rows(ext)
        if shard is not None:
            u = shard.gather_u(u)

        moments = None
        if getattr(strat, "track_moments", False) and state[1] is not None:
            moments = (_to_np(state[1]), _to_np(state[2]), n_all * r)
        return finalize_scoring(
            n_all, n_chunks if shard is None else shard.n_chunks, method,
            strat.result_gram(state, plan), u, hull_rows, r, moments=moments,
        )


def score_chunks(cfg, scaler, Y, **kwargs) -> ScoringResult:
    """One-shot entry: ``ScoringEngine(cfg, scaler).score(Y, ...)``;
    ``chunk_size`` and ``device`` may ride along with the ``score`` kwargs."""
    chunk_size = kwargs.pop("chunk_size", DEFAULT_CHUNK)
    device = kwargs.pop("device", None)
    return ScoringEngine(cfg, scaler, chunk_size=chunk_size, device=device).score(Y, **kwargs)
