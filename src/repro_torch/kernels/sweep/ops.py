"""Fused one-pass sweep wrapper on the CUDA kernel (``csrc/sweep.cu``) for a
CUDA tensor, on ``ref.py`` for a CPU tensor.

The kernel writes the carried state itself — SX' = SX + S·(√w·X), each
bucket's points added in ascending order from the carry, and the moments'
sums added to their carry — so the engines' state layouts are those of the
unfused formulation. It is float32 only and refuses a float64 sketch.
Validity is a count of valid points (``n_valid``), scaled by the r P rows of
each point; rows past it are never extreme, while the sketch, z and moments
take every row given (the caller zeroes a padding row's √w). A row of the
plan must lie in [0, sketch), as index_add requires. For D ≤ kSlabCols one
call is one main launch; past it, a front launch (the chunk's stable
partition by bucket range, and the block CTAs where P rows or Ω need them)
and a tile launch (SX', and z without Ω). With dirs or moments a fold
launch follows. P rows take d ≤ MAX_DP (``core/scoring.py`` scores a wider
P beside the sweep).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.sweep.ref import fused_sweep_ref

__all__ = ["fused_sweep_update", "launch_plan", "LAUNCHES"]

_C = _lib.CUDA_CONSTANTS["common.cuh"]
_S = _lib.CUDA_CONSTANTS["sweep.cu"]
MAX_DP = _C["REPRO_MAX_DP"]
SLAB_COLS = _S["kSlabCols"]  # past this D, the partition and the sketch tiles
MAX_BLOCK_ROWS = _C["kExtMaxBlockRows"]  # P rows a block CTA stages
# the plan's own targets
SEG_POINTS = 512        # points a sketch CTA expects (it holds 4,096 at a time) ...
SEG_POINTS_ALONE = 128  # ... or with no directions, when block CTAs are light
BLOCK_FLOATS = 12_288   # floats a block CTA stages (P rows padded, √w·X rows)
SKETCH_FLOATS = 16_384  # SX floats a sketch CTA copies, about at most
# D > SLAB_COLS, measured by scripts/torch_plan_timings.py (PERF.md §6)
WIDE_BUCKETS = (4, 8, 16)  # buckets a range: the kernel's choices
RANGE_POINTS = 16          # points a range expects: bk the choice nearest sk·16/c
WIDE_TILE_THREADS = 128    # threads a sketch tile, at most (4 columns each)
LAUNCHES = 0
PATH_LAUNCHES = {"narrow": 0, "wide": 0}  # D ≤ kSlabCols, and the partition and tiles past it


def _blocks(c: int, D: int, r: int, d: int, m: int, target: int) -> tuple[int, int]:
    """``pb`` points a block CTA, of about ``target`` CTAs (whole 16-row tiles
    of P, at most BLOCK_FLOATS staged, but one tile where a row is wider than
    that: the kernel then stages no √w·X and reads it as it writes z), and
    ``warps`` scoring warps a block CTA (128 directions each)."""
    tile = _C["kExtTile"]
    unit = tile // math.gcd(r, tile)  # pb·r: whole 16-row tiles
    cap = min(MAX_BLOCK_ROWS // r, BLOCK_FLOATS // (D + r * (-(-d // 4) * 4)))
    pb = -(-c // target)
    pb = max(1, min(max(unit, cap // unit * unit), -(-pb // unit) * unit))
    warps = min(_C["kExtMaxWarps"], max(1, -(-m // _C["kExtWarpDirs"])))
    return pb, warps


def launch_plan(c: int, D: int, r: int, d: int, sk: int, m: int, sms: int) -> dict:
    """The launch of one call. D ≤ SLAB_COLS: ``bk`` buckets a sketch CTA, of
    ``ns`` (enough CTAs that each expects about SEG_POINTS points,
    SEG_POINTS_ALONE with no directions, and copies about SKETCH_FLOATS of
    SX), and block CTAs (``_blocks``), so sketch and block CTAs together are
    about kExtCtasPerSm an SM and start at once. D > SLAB_COLS: ``bk``
    buckets a range (of WIDE_BUCKETS, the one whose range expects nearest
    RANGE_POINTS points), ``ns`` ranges; tiles of ``tile_threads``
    threads (4 columns each, at most WIDE_TILE_THREADS), ``slabs`` of them a
    range, together covering D; ``parts`` partition units, CTAs of the
    front launch's ``part_warps`` warps, of ``part_pts`` points a warp (at
    least kPartPoints, at most kMaxParts units); block CTAs about
    kExtCtasPerSm an SM."""
    if D > SLAB_COLS:
        want = math.log2(RANGE_POINTS * sk / max(c, 1))
        bk = min(WIDE_BUCKETS, key=lambda b: abs(math.log2(b) - want))
        slabs = -(-D // (4 * WIDE_TILE_THREADS))
        threads = -(-D // (4 * 32 * slabs)) * 32
        pb, warps = _blocks(c, D, r, d, m, _C["kExtCtasPerSm"] * sms)
        pw = max(256, 32 * warps) // 32 if m else 8  # the front launch's warps
        parts = min(_S["kMaxParts"], max(1, -(-c // (pw * _S["kPartPoints"]))))
        part_pts = max(32, -(-c // (32 * pw * parts)) * 32)
        return dict(bk=bk, ns=-(-sk // bk), slabs=-(-D // (4 * threads)), tile_threads=threads,
                    parts=parts, part_warps=pw, part_pts=part_pts, pb=pb, nblk=-(-c // pb),
                    warps=warps)
    seg = SEG_POINTS if m else SEG_POINTS_ALONE
    ns = max(1, -(-c // seg), -(-sk * D // SKETCH_FLOATS))
    bk = -(-sk // ns)
    ns = -(-sk // bk)
    pb, warps = _blocks(c, D, r, d, m, max(1, _C["kExtCtasPerSm"] * sms - ns))
    return dict(bk=bk, ns=ns, pb=pb, nblk=-(-c // pb), warps=warps)


def fused_sweep_update(
    SX, X, P, sw, rows, signs, *, dirs=None, omega=None, n_valid=None,
    moments=None, want_z: bool = True, backend: str | None = None,
):
    """One fused sweep step over a (c, D) basis block.

    SX (sketch, D) CountSketch carry; X (c, D) basis rows; P (c·r, d)
    derivative rows or None; sw (c,) √weights; rows/signs (c,) the chunk's
    CountSketch plan; dirs (m, d) direction net or None; omega (D, q) or
    None; moments optional (Σp, Σppᵀ) carry. Returns ``(SX', z, ext,
    moments')``: z = (√w·X)Ω (None unless ``want_z``), ext the chunk-local
    (vmax, imax, vmin, imin) against dirs (None without dirs), moments' the
    accumulated carry (None without moments).
    """
    global LAUNCHES
    if _lib.resolve_backend(backend, X, "sweep") == "torch":
        return fused_sweep_ref(
            SX, X, P, sw, rows, signs, dirs=dirs, omega=omega, n_valid=n_valid,
            moments=moments, want_z=want_z,
        )
    if SX.dtype != torch.float32 or X.dtype != torch.float32:
        raise ValueError(
            "the fused sweep kernel is float32 only — a float64 CountSketch "
            "accumulator is not supported"
        )
    c, D = X.shape
    sk = SX.shape[0]
    if P is None and (dirs is not None or moments is not None):
        raise ValueError("dirs and moments need the P rows")
    r, d = (1, 1) if P is None else (P.shape[0] // max(c, 1), P.shape[1])
    if P is not None and P.shape[0] != r * c:
        raise ValueError(f"P must hold r·c rows, got {P.shape[0]} for c={c}")
    if d > MAX_DP:
        raise ValueError(f"the sweep kernel takes P rows of d ≤ {MAX_DP}, got {d}")
    rows = rows.to(torch.int32).contiguous()
    signs = signs.to(torch.float32).contiguous()
    s1c, s2c = (None, None) if moments is None else moments
    m = 0 if dirs is None else dirs.shape[0]
    q = 0 if omega is None else omega.shape[1]
    for name, t, shape in (("sw", sw, (c,)), ("dirs", dirs, (m, d)), ("omega", omega, (D, q)),
                           ("Σp", s1c, (d,)), ("Σppᵀ", s2c, (d, d))):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    _lib.require_cuda(SX, X, P, sw, rows, signs, dirs, omega, s1c, s2c)
    dev = X.device
    plan = launch_plan(c, D, r, d, sk, m, _lib.sm_count(dev.index or 0))
    wide = D > SLAB_COLS
    blocks = dirs is not None or moments is not None or (want_z and (omega is not None or not wide))
    nblk = plan["nblk"] if blocks else 0
    nm = d + d * (d + 1) // 2
    scratch = torch.empty(max(1, nblk * (4 * m + nm)), dtype=torch.float32, device=dev)
    # the partition's list (4 ints a point, first: 16-byte aligned) and counts
    pscratch = (torch.empty(4 * c + plan["parts"] * plan["ns"] * plan["part_warps"],
                            dtype=torch.int32, device=dev) if wide else None)
    f32 = dict(dtype=torch.float32, device=dev)
    SXo = torch.empty((sk, D), **f32)
    z = torch.empty((c, q if omega is not None else D), **f32) if want_z else None
    small = torch.empty(4 * m + d + d * d, **f32)  # vmax, vmin, imax, imin, Σp, Σppᵀ
    ints = small[2 * m:4 * m].view(torch.int32)
    ext = None
    if dirs is not None:
        ext = (small[:m], ints[:m], small[m:2 * m], ints[m:])
    out_moments = None
    if moments is not None:
        out_moments = (small[4 * m:4 * m + d], small[4 * m + d:].view(d, d))
    e = (None,) * 4 if ext is None else ext
    mo = (None, None) if out_moments is None else out_moments
    nv = c if n_valid is None else int(n_valid)
    _lib.check(
        _lib.lib().repro_sweep(
            _lib.ptr(X), c, D, _lib.ptr(sw), _lib.ptr(rows), _lib.ptr(signs),
            _lib.ptr(P), r, d, nv, _lib.ptr(dirs), m, _lib.ptr(omega), q, _lib.ptr(SX), sk,
            _lib.ptr(s1c), _lib.ptr(s2c), plan["pb"], plan["bk"], plan["warps"],
            plan.get("tile_threads", 0), plan.get("parts", 0), plan.get("part_pts", 0),
            _lib.ptr(scratch), scratch.data_ptr() + 4 * nblk * (2 * m + nm), _lib.ptr(pscratch),
            _lib.ptr(SXo), _lib.ptr(z), *(_lib.ptr(t) for t in mo), *(_lib.ptr(t) for t in e),
            _lib.stream_ptr(dev),
        ),
        "repro_sweep",
    )
    LAUNCHES += 1
    PATH_LAUNCHES["wide" if wide else "narrow"] += 1
    return SXo, z, ext, out_moments
