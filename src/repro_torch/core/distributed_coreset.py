"""Distributed coreset construction over a data mesh — the port of
``repro.core.distributed_coreset``, over ``torch.distributed``
(``repro_torch.distributed.DataMesh``: one process per device).

Primitives (whole-shard bodies, inputs given whole on every rank):
  * ``distributed_gram`` / ``distributed_leverage`` — each rank's row block
    on the gram kernel, one fold, local projections, the rows gathered.
  * ``distributed_scoring_stats`` — (G, Σp, Σppᵀ) in one fold.
  * ``distributed_direction_argmax`` — each rank's argmax ⟨p, v⟩ on the
    extremes kernel, then the cross-rank max of (score, global row) pairs:
    ragged n leaves the last ranks short or empty, and a rank without rows
    offers −inf, so every index is a real row, ties to the lowest row.

``DistributedScoringEngine`` — Algorithm 1's scoring on the mesh. Rank r
takes rows [r·per, (r+1)·per) of the layout ``shard_layout`` gives (per =
chunks_per_shard · chunk, the reference's row rule), cut at n: the rows past
n are never materialized, so they add nothing to any sum and offer no
extreme. Each rank runs the single-host engine's own chunk loop
(``ScoringEngine._drive``) on its rows — the port's per-chunk kernels
(bernstein, gram, extremes, the sweep) through ``pass1_update``,
``leverage_chunk``, ``hull_chunk_extremes`` and ``_sweep_update`` — with
its chunks at their global rows, and the mesh steps in three places:

  collectives: ONE fold a sweep of the strategy state ((G, Σp, Σppᵀ) for
           ``TwoPassExact``, (SX, Σp, Σppᵀ) for ``TwoPassSketched``, SX for
           ``OnePassSketched``; the f64 Gram folds in float64), one gather
           pair (values, then global row ids) for the hull extremes
           (``_extremes_cross_shard``: the running extremes are
           ``scoring.RunningExtremes``, the reference's
           ``_extremes_init``/``_fold``/``_step``), and the leverage rows
           gathered once at the end.
  draws:   the CountSketch plan is drawn (or given) for the global n and each
           rank slices its own rows; the hull net and the sample draw come
           from the same generator state on every rank, so every rank
           returns the same coreset, bit for bit.

The between-sweep algebra is the single-host engine's (host float64 eigh of
the folded Gram, the moment or upfront net). A world of 1 makes no
collective and scores exactly as ``ScoringEngine`` with the same chunk size.

``sweep_ckpt=`` makes the sweeps resumable on the mesh: each rank keeps its
own partials under ``<dir>/rank<r>/`` (the single-host engine's checkpoints:
its carry, cursor and generator state), and the fold runs once, after the
last segment, so a resumed sweep lands on the uninterrupted bits. The
checkpoints hold one (n, world, chunk) layout (``layout.json``); resuming
under another layout raises.

``distributed_build_coreset`` returns ``coreset.build_coreset``'s contract
with the same draw order (plan, hull normals, sample). ``stage_rows`` keeps
only the rank's rows of a stream of host blocks (O(chunk·width) host memory).
``host_gather`` and ``kv_allreduce`` are ``repro_torch.distributed``'s.

Refused as in the reference: a sketched strategy with ``gram_dtype=
"float64"`` (the mesh folds the sketch in float32).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.hull import stable_first_unique
from repro_torch.core.scoring import (
    DEFAULT_CHUNK,
    RunningExtremes,
    ScoringEngine,
    ScoringResult,
    TwoPassExact,
    _Sweeps,
    gram_projection,
    hull_chunk_extremes,
    pass1_update,
)
from repro_torch.device import to_tensor
from repro_torch.distributed.mesh import DataMesh, host_gather, kv_allreduce
from repro_torch.kernels.gram import gram_matrix

__all__ = [
    "distributed_gram",
    "distributed_leverage",
    "distributed_direction_argmax",
    "distributed_coreset_scores",
    "distributed_scoring_stats",
    "DistributedScoringEngine",
    "StagedRows",
    "distributed_build_coreset",
    "host_gather",
    "kv_allreduce",
    "shard_layout",
    "rank_rows",
]


def shard_layout(mesh: DataMesh, axis, n: int, chunk_size: int | None):
    """(chunk, chunks_per_shard, n_pad) for n rows chunk-scanned over a mesh:
    the one row rule every sharded driver follows (the scoring engine, the
    fits and the evaluators), the reference's. ``axis`` must be the mesh's
    data axes; every rank is a shard."""
    mesh.check_axis(axis)
    shards = mesh.world
    per_needed = -(-n // shards)
    chunk = int(chunk_size) if chunk_size else per_needed
    chunk = max(min(chunk, per_needed), 1)
    cps = -(-per_needed // chunk)
    return chunk, cps, cps * chunk * shards


def rank_rows(mesh: DataMesh, n: int, chunk_size: int | None, axis=None):
    """(lo, hi, chunk, cps): this rank's global rows [lo, hi) of the layout
    and its chunking (rows past n dropped); ``axis`` defaults to the
    mesh's."""
    chunk, cps, _ = shard_layout(mesh, mesh.axes if axis is None else axis, n, chunk_size)
    per = cps * chunk
    lo = min(mesh.rank * per, n)
    return lo, min(mesh.rank * per + per, n), chunk, cps


def _block(X: torch.Tensor, mesh: DataMesh, axis) -> tuple[torch.Tensor, int]:
    """This rank's rows of a whole input (per = ⌈n/world⌉) and their base."""
    mesh.check_axis(axis)
    n = int(X.shape[0])
    per = -(-n // mesh.world)
    lo = min(mesh.rank * per, n)
    return X[lo:min(lo + per, n)], lo


def distributed_gram(X, mesh: DataMesh, axis="data") -> torch.Tensor:
    """G = XᵀX, X's rows split over the ranks: the gram kernel on each block,
    one fold; the same G on every rank."""
    Xb, _ = _block(to_tensor(X, torch.float32), mesh, axis)
    return mesh.fold([gram_matrix(Xb.to(mesh.device).contiguous())])[0]


def distributed_leverage(X, mesh: DataMesh, axis="data") -> torch.Tensor:
    """Leverage scores of X (n,): one fold of the Gram, local projections
    (``gram_projection``), the rows gathered."""
    X = to_tensor(X, torch.float32)
    Xb, _ = _block(X, mesh, axis)
    Xb = Xb.to(mesh.device).contiguous()
    G = mesh.fold([gram_matrix(Xb)])[0]
    V, inv = gram_projection(G)
    u = torch.sum(torch.square(Xb @ V) * inv, dim=1)
    n = int(X.shape[0])
    return mesh.gather_rows(u, -(-n // mesh.world), n)


def distributed_coreset_scores(X, mesh: DataMesh, axis="data") -> torch.Tensor:
    """s_i = u_i + 1/n (the Algorithm-1 score step)."""
    return distributed_leverage(X, mesh, axis) + 1.0 / int(np.shape(X)[0])


def distributed_scoring_stats(X, P_pts, mesh: DataMesh, axis="data"):
    """The scoring engine's pass-1 statistics (G = XᵀX, Σp, Σppᵀ), each
    input's rows split over the ranks, in ONE fold."""
    dev = mesh.device
    Xb, _ = _block(to_tensor(X, torch.float32), mesh, axis)
    Pb, _ = _block(to_tensor(P_pts, torch.float32), mesh, axis)
    D, p = int(Xb.shape[1]), int(Pb.shape[1])
    f32 = dict(dtype=torch.float32, device=dev)
    G, s1, s2 = pass1_update(torch.zeros((D, D), **f32), torch.zeros(p, **f32),
                             torch.zeros((p, p), **f32), Xb.to(dev).contiguous(),
                             Pb.to(dev).contiguous(), torch.ones(Xb.shape[0], **f32))
    return tuple(mesh.fold([G, s1, s2]))


def _extremes_cross_shard(ext, mesh: DataMesh):
    """Cross-rank running-extreme reduction: ONE gather pair (values, then
    global row ids), the lowest rank winning ties. Returns the
    per-direction global (argmax, argmin) row ids as device tensors (no
    host read)."""
    dev = mesh.device
    vals = torch.stack([torch.as_tensor(ext.best_max, device=dev),
                        -torch.as_tensor(ext.best_min, device=dev)]).float()
    ids = torch.stack([torch.as_tensor(ext.best_imax, device=dev),
                       torch.as_tensor(ext.best_imin, device=dev)]).long()
    allv = mesh.all_gather(vals, "hull_gather")
    alli = mesh.all_gather(ids, "hull_gather")
    win = torch.argmax(allv, dim=0)  # (2, m): the first rank on ties
    best = torch.gather(alli, 0, win[None])[0]
    return best[0], best[1]


def distributed_direction_argmax(P_pts, dirs, mesh: DataMesh, axis="data") -> np.ndarray:
    """Global argmax_i ⟨p_i, v⟩ per direction (m,), P's rows split over the
    ranks: each block's extremes on the extremes kernel, then the gather
    pair. Ragged n is exact; empty input raises."""
    P_pts = to_tensor(P_pts, torch.float32)
    n = int(P_pts.shape[0])
    if n == 0:
        raise ValueError(
            "distributed_direction_argmax: empty input (every shard would be empty "
            "and the per-direction argmax is undefined)")
    dev = mesh.device
    dirs = to_tensor(dirs, torch.float32, dev).contiguous()
    Pb, lo = _block(P_pts, mesh, axis)
    ext = RunningExtremes(int(dirs.shape[0]), dev)
    if Pb.shape[0]:
        ext.update(*hull_chunk_extremes(Pb.to(dev).contiguous(), dirs), offset=lo)
    return _extremes_cross_shard(ext, mesh)[0].cpu().numpy()


@dataclasses.dataclass
class _Shard:
    """What ``ScoringEngine._drive`` needs to run as one rank of a mesh."""

    mesh: DataMesh
    n: int                 # global rows
    base: int              # global row of the rank's first row
    per: int               # layout rows a rank (the gather's block)
    ranges: list           # the rank's chunk ranges (local rows, empty ones kept)
    n_chunks: int          # chunks over the whole mesh
    probe: torch.Tensor    # one row of Y, for the shapes on a rank without rows

    def hull_rows(self, ext: RunningExtremes) -> np.ndarray:
        gimax, gimin = _extremes_cross_shard(ext, self.mesh)
        return stable_first_unique(torch.cat([gimax, gimin]).cpu().numpy())

    def gather_u(self, u: torch.Tensor) -> torch.Tensor:
        return self.mesh.gather_rows(u, self.per, self.n)


@dataclasses.dataclass
class StagedRows:
    """One rank's rows of a staged input (``DistributedScoringEngine.
    stage_rows``): ``rows`` are global rows [lo, lo + len(rows)) of n."""

    rows: torch.Tensor
    n: int
    lo: int
    probe: torch.Tensor


class DistributedScoringEngine:
    """Algorithm 1's scoring on a data mesh (module doc): the
    ``ScoringEngine.score`` contract and result, every data-sized step on the
    rank's own rows, one fold a sweep and one gather pair for the hull.

    ``featurize`` (or cfg and scaler) as for ``ScoringEngine``; ``axis``
    the mesh's data axes (one name or a tuple). The rank's device is
    ``mesh.device``."""

    def __init__(
        self,
        cfg=None,
        scaler=None,
        *,
        mesh: DataMesh,
        axis="data",
        featurize: Callable | None = None,
        chunk_size: int | None = DEFAULT_CHUNK,
        rows_per_point: int | None = None,
        hull_oversample: int = 4,
        gram_dtype: str = "float32",
    ):
        mesh.check_axis(axis)
        self.mesh = mesh
        self.chunk_size = int(chunk_size) if chunk_size else 0
        self._engine = ScoringEngine(
            cfg, scaler, featurize=featurize, chunk_size=chunk_size,
            rows_per_point=rows_per_point, hull_oversample=hull_oversample,
            gram_dtype=gram_dtype, device=mesh.device,
        )
        self.rows_per_point = self._engine.rows_per_point

    def _rows(self, n: int):
        return rank_rows(self.mesh, n, self.chunk_size)

    def stage_rows(self, blocks, n: int, width: int, dtype=torch.float32) -> StagedRows:
        """This rank's rows of n feature rows streamed as host blocks
        (``blocks`` yields (b_i, width) arrays or tensors with Σb_i = n):
        each block is cut at the rank's boundaries and only its rows move to
        the device, so host memory stays O(block). Every rank reads every
        block. Pass the result to ``score`` in place of Y."""
        lo, hi, _, _ = self._rows(n)
        parts, off, probe = [], 0, None
        for block in blocks:
            block = to_tensor(block, dtype)
            if block.ndim != 2 or block.shape[1] != width:
                raise ValueError(f"stage_rows: blocks must be (b, {width})")
            if probe is None and block.shape[0]:
                probe = block[:1].to(self.mesh.device)
            end = off + int(block.shape[0])
            a, b = max(off, lo), min(end, hi)
            if a < b:
                parts.append(block[a - off:b - off].to(self.mesh.device))
            off = end
        if off != n or probe is None:
            raise ValueError(f"stage_rows: blocks carried {off} rows, expected {n}")
        rows = torch.cat(parts) if parts else probe[:0]
        return StagedRows(rows.contiguous(), n, lo, probe)

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
        n_valid: int | None = None,
    ) -> ScoringResult:
        """Score all n points on the mesh: ``ScoringEngine.score``'s
        arguments and result, the same on every rank. ``Y`` is the whole
        input (each rank takes its rows) or this rank's ``StagedRows``;
        ``weights`` are the n points' weights. ``n_valid``, the reference's
        true row count of a staged input, must be the n that ``Y`` carries
        (the staged rows hold no padding). ``sweep_ckpt``/``resume``:
        resumable sweeps, per rank (module doc)."""
        eng = self._engine
        n = Y.n if isinstance(Y, StagedRows) else int(np.shape(Y)[0])
        if n_valid is not None and int(n_valid) != n:
            raise ValueError(f"n_valid={n_valid} but the input carries {n} rows")
        strat = eng._strategy(method, n, generator, sketch_size, hull_k, hull_normals,
                              hull_dirs, strategy, gram_dtype, plan)
        if not isinstance(strat, TwoPassExact) and getattr(strat, "gram_dtype", "") == "float64":
            raise NotImplementedError(
                "gram_dtype='float64' sketched accumulation is single-host only (the "
                "mesh folds the sketch in float32)")
        if hull_k > 0 and n * self.rows_per_point > np.iinfo(np.int32).max:
            raise ValueError("hull selection over more than 2^31-1 derivative rows would "
                             "overflow the int32 hull-row ids of the extremes kernel")
        Y_loc, sqrt_w, chunk, shard = self._rank_inputs(Y, weights)
        if sweep_ckpt is not None:
            sweep_ckpt = self._rank_ckpt(sweep_ckpt, n, chunk, resume)
        return eng._drive(
            strat, generator, plan, Y_loc, sqrt_w, int(Y_loc.shape[0]), chunk, method,
            ridge_reg, hull_k, hull_normals, hull_dirs, sweep_ckpt=sweep_ckpt, resume=resume,
            shard=shard,
        )

    def _rank_inputs(self, Y, weights=None):
        """This rank's rows of ``Y`` (whole, or ``StagedRows``) on its
        device, their √w, the chunk and the ``_Shard`` the engine's loop
        runs as."""
        dev = self.mesh.device
        if isinstance(Y, StagedRows):
            n, Y_loc, probe = Y.n, Y.rows, Y.probe
            lo, hi, chunk, cps = self._rows(n)
            if (Y.lo, Y.lo + int(Y_loc.shape[0])) != (lo, hi):
                raise ValueError("staged rows do not match this rank's layout (use stage_rows)")
        else:
            n = int(np.shape(Y)[0])
            lo, hi, chunk, cps = self._rows(n)
            Y_loc = to_tensor(Y[lo:hi], torch.float32, dev)
            probe = to_tensor(Y[:1], torch.float32, dev)
        sqrt_w = None
        if weights is not None:
            if not isinstance(weights, torch.Tensor):
                weights = np.asarray(weights)
            sqrt_w = torch.sqrt(to_tensor(weights[lo:hi], torch.float32, dev))
        n_loc = hi - lo
        ranges = [(min(ci * chunk, n_loc), min((ci + 1) * chunk, n_loc)) for ci in range(cps)]
        shard = _Shard(self.mesh, n, lo, cps * chunk, ranges, cps * self.mesh.world, probe)
        return Y_loc, sqrt_w, chunk, shard

    def rank_sweeps(self, Y, strategy, *, hull_k: int = 0, weights=None):
        """This rank's sweeps of a ``score`` call as callables (the engine's
        ``_Sweeps``: ``sweep1``/``sweep2`` over a range of chunks, no
        collective): what the invariant auditor and the dry run drive,
        as the reference drives ``make_sharded_pass_fns``' bodies."""
        Y_loc, sqrt_w, chunk, shard = self._rank_inputs(Y, weights)
        return _Sweeps(self._engine, strategy, Y_loc, sqrt_w, int(Y_loc.shape[0]), chunk, hull_k,
                       shard)

    def _rank_ckpt(self, root, n: int, chunk: int, resume: bool) -> str:
        """This rank's checkpoint directory, holding one (n, world, chunk)
        layout."""
        root = root if isinstance(root, (str, os.PathLike)) else getattr(root, "directory")
        path = os.path.join(str(root), f"rank{self.mesh.rank}")
        os.makedirs(path, exist_ok=True)
        layout = {"n": n, "world": self.mesh.world, "chunk": chunk}
        meta = os.path.join(path, "layout.json")
        if resume and os.path.exists(meta):
            with open(meta) as f:
                saved = json.load(f)
            if saved != layout:
                raise ValueError(f"sweep checkpoints hold the layout {saved}; this call's is "
                                 f"{layout}: resume requires the layout that wrote them")
        else:
            with open(meta, "w") as f:
                json.dump(layout, f)
        return path


def distributed_build_coreset(
    cfg,
    scaler,
    Y,
    k: int,
    method: str = "l2-hull",
    *,
    mesh: DataMesh,
    generator: torch.Generator | None = None,
    axis="data",
    alpha: float = 0.8,
    sketch_size: int = 0,
    chunk_size: int | None = DEFAULT_CHUNK,
    plan=None,
    hull_normals=None,
    hull_dirs=None,
    draw=None,
    sweep_ckpt=None,
    resume: bool = False,
):
    """Paper Algorithm 1 with the scoring on the mesh: ``build_coreset``'s
    contract and draws (``plan``, ``hull_normals``, ``draw`` or, in that
    order, ``generator``), the same coreset on every rank."""
    from repro_torch.core.coreset import CoresetResult, coreset_from_scoring

    t0 = time.perf_counter()
    Y = np.asarray(Y)
    n = Y.shape[0]
    k = min(k, n)
    if method == "uniform":
        if draw is None:
            if generator is None:
                raise ValueError("uniform sampling requires generator or draw")
            draw = torch.randperm(n, generator=generator)[:k].numpy()
        return CoresetResult(np.asarray(draw, np.int64), np.full(k, n / k), None, method,
                             time.perf_counter() - t0)
    k_hull = k - int(np.floor(alpha * k)) if method == "l2-hull" else 0
    engine = DistributedScoringEngine(cfg, scaler, mesh=mesh, axis=axis, chunk_size=chunk_size)
    res = engine.score(
        Y, method=method, generator=generator, plan=plan, sketch_size=sketch_size,
        hull_k=k_hull, hull_normals=hull_normals, hull_dirs=hull_dirs,
        sweep_ckpt=sweep_ckpt, resume=resume,
    )
    return coreset_from_scoring(res, n, k, method, alpha, t0, generator=generator, draw=draw)
