"""Directional-extremes wrapper on the CUDA kernel (``csrc/extremes.cu``)
for a CUDA tensor, on ``ref.py`` for a CPU tensor. Row validity is a count:
rows at or past ``n_valid`` are never extreme. Points of d ≤ ``MAX_DP``
coordinates take the kernel's template body, wider ones its wide body
(``PATH_LAUNCHES`` counts each; ``wide_launch_plan`` picks its tile)."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.extremes.ref import directional_extremes_ref

_C = _lib.CUDA_CONSTANTS["common.cuh"]
MAX_DP = _C["REPRO_MAX_DP"]
DIRS_PER_WARP = _C["kExtWarpDirs"]  # directions a warp of a score CTA
MAX_WARPS = _C["kExtMaxWarps"]      # warps of a score CTA
TILE_ROWS = _C["kExtTile"]          # rows of the tile-max loop; a block is whole tiles
MAX_BLOCK_ROWS = _C["kExtMaxBlockRows"]
CTAS_PER_SM = _C["kExtCtasPerSm"]   # score CTAs an SM holds: the grid the plan aims at
_W = _lib.CUDA_CONSTANTS["extremes.cu"]
# the wide body's tiles (csrc/extremes.cu:launch_wide): (directions, rows,
# CTAs an SM); tile 1 is m = 1's
WIDE_TILES = (
    (_W["kExtWideTileDirs"], _W["kExtWideTileRows"], _W["kExtWideCtasPerSm"]),
    (1, 32 * _W["kExtWideOneWarps"], _W["kExtWideOneCtasPerSm"]),
)
WARP_DIRS = 4 * _W["kExtWideRd"]  # directions of a warp of tile 0
LAUNCHES = 0
PATH_LAUNCHES = {"template": 0, "wide": 0}


def launch_plan(rows: int, m: int, sms: int) -> tuple[int, int, int]:
    """(rb, warps, nblk) of a score launch over ``rows`` rows of P and ``m``
    directions on a card of ``sms`` SMs: CTA rows of ``warps`` warps cover
    the directions in as few rows of at most MAX_WARPS warps as possible,
    and rows are cut into ``nblk`` blocks of ``rb`` rows so the grid is
    about CTAS_PER_SM CTAs an SM."""
    n_warps = -(-m // DIRS_PER_WARP)
    cta_rows = -(-n_warps // MAX_WARPS)
    warps = -(-n_warps // cta_rows)
    target = max(1, CTAS_PER_SM * sms // cta_rows)
    rb = -(-max(rows, 1) // target)
    rb = min(MAX_BLOCK_ROWS, -(-rb // TILE_ROWS) * TILE_ROWS)
    return rb, warps, -(-rows // rb)


class WidePlan(NamedTuple):
    """A wide-body launch: ``tile`` (0 or 1), blocks of ``rb`` rows (whole
    tiles), ``nrb`` of them, a partial each."""
    tile: int
    rb: int
    nrb: int


@functools.lru_cache(maxsize=256)
def wide_launch_plan(rows: int, m: int, sms: int) -> WidePlan:
    """The wide body's launch (d > MAX_DP) over ``rows`` rows of P and ``m``
    directions on a card of ``sms`` SMs: tile 1 for m = 1, else tile 0; then
    blocks of t tiles of rows, t the largest of those that take the fewest
    waves × t tile times (CTAs of tiles of directions × blocks, the tile's
    CTAs an SM at once): a whole wave where the work allows one. (Timed at
    m = 1, d 70 and 1,024 over 16,384 rows: blocks of 2–128 tiles, fewer
    partials to fold, take longer than the plan's one tile a block.)"""
    tile = 1 if m == 1 else 0
    dirs, trows, per_sm = WIDE_TILES[tile]
    dir_tiles = -(-m // dirs)
    row_tiles = max(1, -(-rows // trows))
    slots = per_sm * sms
    best, tpb = None, 1
    for t in range(1, row_tiles + 1):
        cost = -(-dir_tiles * -(-row_tiles // t) // slots) * t
        if best is None or cost <= best:
            best, tpb = cost, t
    rb = tpb * trows
    return WidePlan(tile, rb, -(-rows // rb))


def directional_extremes(
    P: torch.Tensor,
    dirs: torch.Tensor,
    n_valid: int | None = None,
    *,
    backend: str | None = None,
):
    """P (rows, d) f32, dirs (m, d) f32 → (vmax, imax, vmin, imin), each (m,),
    indices int32 row ids into P."""
    global LAUNCHES
    if _lib.resolve_backend(backend, P, "extremes") == "torch":
        return directional_extremes_ref(P, dirs, n_valid)
    if P.dtype != torch.float32 or dirs.dtype != torch.float32:
        raise ValueError("the extremes kernel is float32 only")
    rows, d = P.shape
    m = dirs.shape[0]
    if dirs.shape[1] != d or d < 1 or m == 0:
        raise ValueError(f"expected P (rows, d) and dirs (m ≥ 1, d), got {tuple(P.shape)}, {tuple(dirs.shape)}")
    nv = rows if n_valid is None else int(n_valid)
    _lib.require_cuda(P, dirs)
    dev = P.device
    sms = _lib.sm_count(dev.index or 0)
    if d > MAX_DP:
        path = "wide"
        shape, rb, nblk = wide_launch_plan(rows, m, sms)
    else:
        path = "template"
        rb, shape, nblk = launch_plan(rows, m, sms)
    scratch = torch.empty(max(1, 4 * nblk * m), dtype=torch.float32, device=dev)
    out = torch.empty(4 * m, dtype=torch.float32, device=dev)
    ints = out[2 * m:].view(torch.int32)
    _lib.check(
        _lib.lib().repro_extremes(
            _lib.ptr(P), rows, d, nv, _lib.ptr(dirs), m, rb, shape, _lib.ptr(scratch),
            scratch.data_ptr() + 8 * nblk * m, _lib.ptr(out), _lib.ptr(ints),
            out.data_ptr() + 4 * m, ints.data_ptr() + 4 * m, _lib.stream_ptr(dev),
        ),
        "repro_extremes",
    )
    LAUNCHES += 1
    PATH_LAUNCHES[path] += 1
    return out[:m], ints[:m], out[m:2 * m], ints[m:]
