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

The strategy contract is the reference's: ``init_state`` / ``update`` /
``fused_update`` / ``gram`` / ``result_gram`` / ``moments``; the chunk loop,
running extremes and ``ScoringResult`` assembly live once in the engine. The
between-pass algebra (eigh of the (Jd)² Gram, the direction net) is host
float64 numpy, as in the reference.

Random plans are inputs: torch cannot reproduce ``jax.random``, so the
CountSketch rows/signs (and Ω) come in as ``plan=`` and the hull net's
normal draws as ``hull_normals=`` (or the whole net as ``hull_dirs=``);
without them they are drawn from ``generator``.

Not ported yet (they raise ``NotImplementedError``): ``sweep_ckpt=`` /
``resume=`` checkpointed sweeps and ``gram_dtype="float64"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.hull import hull_directions, stable_first_unique
from repro_torch.device import resolve_device, to_tensor
from repro_torch.kernels.bernstein import bernstein_featurize
from repro_torch.kernels.extremes import directional_extremes
from repro_torch.kernels.gram import gram_matrix
from repro_torch.kernels.sweep import fused_sweep_update

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
    "directions_from_moments",
    "finalize_scoring",
    "DEFAULT_CHUNK",
    "SCORE_METHODS",
]

DEFAULT_CHUNK = 65_536

SCORE_METHODS = ("l2-only", "l2-hull", "ridge-lss", "root-l2")
GRAM_DTYPES = ("float32", "float64")


def _check_gram_dtype(gram_dtype: str) -> None:
    if gram_dtype not in GRAM_DTYPES:
        raise ValueError(f"gram_dtype must be one of {GRAM_DTYPES}")
    if gram_dtype == "float64":
        raise NotImplementedError("gram_dtype='float64' is not ported yet")


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
    """Pass-1 accumulation: Gram of √w-scaled rows (gram kernel, √w fused)
    plus the P first/second moments (``P is None`` skips them)."""
    G = G + gram_matrix(X, sw)
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


def _sketch_update(SX, s1, s2, X, P, sw, rows, signs):
    """Unfused CountSketch accumulation SX += S·(√w·X) — the formulation the
    fused sweep replaces, kept as the tests' cross-check."""
    SX = SX.index_add(0, rows.long(), signs[:, None] * (X * sw[:, None]))
    if P is not None:
        s1, s2 = _moments_update(s1, s2, P)
    return SX, s1, s2


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


def projection_from_gram(G, method: str, ridge_reg: float, rcond: float = 1e-6, device=None):
    """(V, inv) from a float64 host eigh of the (D, D) Gram, returned as f32
    tensors on ``device`` (G's device when None)."""
    dev = G.device if device is None and isinstance(G, torch.Tensor) else device
    G = np.asarray(G.detach().cpu() if isinstance(G, torch.Tensor) else G, np.float64)
    w, V = np.linalg.eigh(G)
    reg = ridge_reg if method == "ridge-lss" else 0.0
    inv = _spectrum_inverse(w, ridge_reg=reg, rcond=rcond)
    f32 = dict(dtype=torch.float32, device=dev)
    return torch.as_tensor(V, **f32), torch.as_tensor(inv, **f32)


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


@dataclasses.dataclass(frozen=True)
class TwoPassExact(PassStrategy):
    """Exact f32 Gram in pass 1 (gram kernel); pass 2 re-streams the chunks
    for leverage and the extremes."""

    gram_dtype: str = "float32"

    def __post_init__(self):
        _check_gram_dtype(self.gram_dtype)

    def init_state(self, D: int, p: int | None, device):
        G = torch.zeros((D, D), dtype=torch.float32, device=device)
        if p is None:
            return (G, None, None)
        return (G, *_moment_state(p, device))

    def update(self, state, X, P, sw, plan_slice=()):
        return pass1_update(*state, X, P, sw), None

    def gram(self, state, plan=None):
        return state[0]


@dataclasses.dataclass(frozen=True)
class _SketchedBase(PassStrategy):
    """Shared CountSketch plan/state of the sketched strategies."""

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
        SX = torch.zeros((self.sketch_size, D), dtype=torch.float32, device=device)
        if p is None:
            return (SX, None, None)
        return (SX, *_moment_state(p, device))

    def gram(self, state, plan=None):
        return state[0].T @ state[0]


@dataclasses.dataclass(frozen=True)
class TwoPassSketched(_SketchedBase):
    """CountSketch Gram in pass 1 through the fused sweep (sketch + moments,
    nothing retained); pass 2 re-streams as ``TwoPassExact`` does."""

    def update(self, state, X, P, sw, plan_slice=()):
        rows, signs = plan_slice
        moments = (state[1], state[2]) if P is not None else None
        SX, _, _, mom = fused_sweep_update(
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
        SX = torch.zeros((self.sketch_size, D), dtype=torch.float32, device=device)
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
        moments = (state[1], state[2]) if state[1] is not None and P is not None else None
        keep_P = dirs is not None or moments is not None
        SX, z, ext, mom = fused_sweep_update(
            state[0], X, P if keep_P else None, sw, rows, signs,
            dirs=dirs, omega=omega, moments=moments,
        )
        s1, s2 = mom if mom is not None else (state[1], state[2])
        return (SX, s1, s2), z, ext

    def gram(self, state, plan=None):
        """Projection Gram (SXΩ)ᵀ(SXΩ), the Gram of the retained z rows."""
        SX = state[0]
        if plan is not None and plan[2] is not None:
            SX = SX @ plan[2]
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
        """
        if sweep_ckpt is not None or resume:
            raise NotImplementedError("sweep_ckpt= / resume= are not ported yet")
        if method not in SCORE_METHODS:
            raise ValueError(f"unknown scoring method: {method}")
        Y = to_tensor(Y, torch.float32, self.device)
        n = int(Y.shape[0])
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
        sqrt_w = None
        if weights is not None:
            sqrt_w = torch.sqrt(to_tensor(weights, torch.float32, self.device))
        chunk = self.chunk_size if self.chunk_size > 0 else n
        return self._drive(
            strat, generator, plan, Y, sqrt_w, n, chunk, method, ridge_reg, hull_k,
            hull_normals, hull_dirs,
        )

    def _net(self, build, hull_normals, hull_dirs, generator):
        if hull_dirs is not None:
            return to_tensor(hull_dirs, torch.float32, self.device)
        return torch.as_tensor(build(normals=hull_normals, generator=generator),
                               device=self.device)

    def _drive(self, strat, generator, plan_in, Y, sqrt_w, n, chunk, method, ridge_reg,
               hull_k, hull_normals, hull_dirs) -> ScoringResult:
        """The shared chunk loop. Sweep 1 streams every chunk through
        ``strat.fused_update`` (one-pass: with the extremes against the
        upfront net). Two-pass strategies re-stream for leverage and the
        extremes against the moment net; one-pass reads leverage off the
        retained z blocks."""
        featurize = self.featurize
        dev = self.device
        r = self.rows_per_point
        want_hull = hull_k > 0
        want_P = want_hull or getattr(strat, "track_moments", False)
        n_chunks = -(-n // chunk)
        ranges = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]

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

        # ---- sweep 1
        state = plan = None
        z_blocks: list = []
        ext = dirs1 = None
        for lo, hi in ranges:
            Xc, Pc, swc = get_chunk(lo, hi)
            if state is None:
                D = int(Xc.shape[1])
                p = int(Pc.shape[1]) if Pc is not None else None
                plan = strat.begin(n, D, generator, plan_in, dev)
                state = strat.init_state(D, p, dev)
                if strat.one_pass and want_hull:
                    dirs1 = self._net(
                        lambda **kw: upfront_directions(p, hull_k, self.hull_oversample, **kw),
                        hull_normals, hull_dirs, generator,
                    )
                    ext = RunningExtremes(int(dirs1.shape[0]))
            state, z, extb = strat.fused_update(
                state, Xc, Pc, swc, strat.slice_plan(plan, lo, hi), dirs=dirs1
            )
            if z is not None:
                z_blocks.append(z)
            if ext is not None:
                ext.update(*extb, offset=lo * r)

        # ---- between sweeps: (Jd)²-scale host algebra
        V, inv = projection_from_gram(strat.gram(state, plan), method, ridge_reg, device=dev)

        hull_rows = None
        if strat.one_pass:
            u = torch.cat([_z_leverage(z, V, inv) for z in z_blocks])
        else:
            # ---- sweep 2: leverage + directional extremes
            if want_hull:
                s1, s2 = strat.moments(state)
                dirs = self._net(
                    lambda **kw: directions_from_moments(
                        s1, s2, n * r, hull_k, self.hull_oversample, **kw),
                    hull_normals, hull_dirs, generator,
                )
                ext = RunningExtremes(int(dirs.shape[0]))
            u = torch.empty(n, dtype=torch.float32, device=dev)
            for lo, hi in ranges:
                Xc, Pc, swc = get_chunk(lo, hi)
                u[lo:hi] = leverage_chunk(Xc, swc, V, inv)
                if ext is not None:
                    ext.update(*hull_chunk_extremes(Pc, dirs), offset=lo * r)
        if ext is not None:
            hull_rows = ext.candidates()

        moments = None
        if getattr(strat, "track_moments", False) and state[1] is not None:
            moments = (_to_np(state[1]), _to_np(state[2]), n * r)
        return finalize_scoring(
            n, n_chunks, method, strat.result_gram(state, plan), u, hull_rows, r,
            moments=moments,
        )


def score_chunks(cfg, scaler, Y, **kwargs) -> ScoringResult:
    """One-shot entry: ``ScoringEngine(cfg, scaler).score(Y, ...)``;
    ``chunk_size`` and ``device`` may ride along with the ``score`` kwargs."""
    chunk_size = kwargs.pop("chunk_size", DEFAULT_CHUNK)
    device = kwargs.pop("device", None)
    return ScoringEngine(cfg, scaler, chunk_size=chunk_size, device=device).score(Y, **kwargs)
