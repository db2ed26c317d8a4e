"""Directional-extremes wrapper on the CUDA kernel (``csrc/extremes.cu``)
for a CUDA tensor, on ``ref.py`` for a CPU tensor. Row validity is a count:
rows at or past ``n_valid`` are never extreme. Points of d ≤ ``MAX_DP``
coordinates take the kernel's template body, wider ones its wide body
(``PATH_LAUNCHES`` counts each)."""
from __future__ import annotations

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
WIDE_WARPS = _W["kExtWideWarps"]    # warps of a wide score CTA: partials a row block
WIDE_ROWS = _W["kExtWideRows"]      # rows of a wide CTA's step; a block is whole steps
WIDE_DIRS = _W["kExtWideDirs"]      # directions of a wide CTA
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


def wide_launch_plan(rows: int, m: int, sms: int) -> tuple[int, int]:
    """(rb, nrb) of a wide-body launch (d > MAX_DP): CTA rows of WIDE_DIRS
    directions cover m, and rows are cut into ``nrb`` blocks of ``rb`` rows
    (whole WIDE_ROWS steps) so the grid is about CTAS_PER_SM CTAs an SM."""
    cta_rows = -(-m // WIDE_DIRS)
    target = max(1, CTAS_PER_SM * sms // cta_rows)
    rb = -(-max(rows, 1) // target)
    rb = -(-rb // WIDE_ROWS) * WIDE_ROWS
    return rb, -(-rows // rb)


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
        path, warps = "wide", 0
        rb, nrb = wide_launch_plan(rows, m, sms)
        nblk = nrb * WIDE_WARPS
    else:
        path = "template"
        rb, warps, nblk = launch_plan(rows, m, sms)
    scratch = torch.empty(max(1, 4 * nblk * m), dtype=torch.float32, device=dev)
    out = torch.empty(4 * m, dtype=torch.float32, device=dev)
    ints = out[2 * m:].view(torch.int32)
    _lib.check(
        _lib.lib().repro_extremes(
            _lib.ptr(P), rows, d, nv, _lib.ptr(dirs), m, rb, warps, _lib.ptr(scratch),
            scratch.data_ptr() + 8 * nblk * m, _lib.ptr(out), _lib.ptr(ints),
            out.data_ptr() + 4 * m, ints.data_ptr() + 4 * m, _lib.stream_ptr(dev),
        ),
        "repro_extremes",
    )
    LAUNCHES += 1
    PATH_LAUNCHES[path] += 1
    return out[:m], ints[:m], out[m:2 * m], ints[m:]
