"""Fused one-pass sweep wrapper on the CUDA kernel (``csrc/sweep.cu``) for a
CUDA tensor, on ``ref.py`` for a CPU tensor.

The kernel writes the carried state itself — SX' = SX + S·(√w·X), each
bucket's points added in ascending order from the carry, and the moments'
sums added to their carry — so the engines' state layouts are those of the
unfused formulation. It is float32 only and refuses a float64 sketch.
Validity is a count of valid points (``n_valid``), scaled by the r P rows of
each point; rows past it are never extreme, while the sketch, z and moments
take every row given (the caller zeroes a padding row's √w). One call is one
main launch plus, with dirs or moments, one fold launch. X takes any width D
(the sketch CTAs add SX a slab of columns at a time); P rows take d ≤
MAX_DP (``core/scoring.py`` scores a wider P beside the sweep).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.sweep.ref import fused_sweep_ref

__all__ = ["fused_sweep_update", "launch_plan", "LAUNCHES"]

_C = _lib.CUDA_CONSTANTS["common.cuh"]
MAX_DP = _C["REPRO_MAX_DP"]
MAX_BLOCK_ROWS = _C["kExtMaxBlockRows"]  # P rows a block CTA stages
# the plan's own targets
SEG_POINTS = 512        # points a sketch CTA expects (it holds 4,096 at a time) ...
SEG_POINTS_ALONE = 128  # ... or with no directions, when block CTAs are light
BLOCK_FLOATS = 12_288   # floats a block CTA stages (P rows padded, √w·X rows)
SKETCH_FLOATS = 16_384  # SX floats a sketch CTA copies, about at most
LAUNCHES = 0
PATH_LAUNCHES = {"narrow": 0, "wide": 0}  # D ≤ kSlabCols, and the slab walk past it


def launch_plan(c: int, D: int, r: int, d: int, sk: int, m: int, sms: int) -> dict:
    """The launch of one call: ``bk`` buckets a sketch CTA, of ``ns``
    (enough CTAs that each expects about SEG_POINTS points, SEG_POINTS_ALONE
    with no directions, and copies about SKETCH_FLOATS of SX); ``pb``
    points a block CTA (whole 16-row tiles of P, at most BLOCK_FLOATS
    staged, but one tile where a row is wider than that: the kernel then
    stages no √w·X and reads it as it writes z), of ``nblk``, so sketch and block CTAs together are about
    kExtCtasPerSm an SM and start at once; ``warps`` scoring warps a block CTA
    (128 directions each)."""
    seg = SEG_POINTS if m else SEG_POINTS_ALONE
    ns = max(1, -(-c // seg), -(-sk * D // SKETCH_FLOATS))
    bk = -(-sk // ns)
    ns = -(-sk // bk)
    target = max(1, _C["kExtCtasPerSm"] * sms - ns)
    tile = _C["kExtTile"]
    unit = tile // math.gcd(r, tile)  # pb·r: whole 16-row tiles
    cap = min(MAX_BLOCK_ROWS // r, BLOCK_FLOATS // (D + r * (-(-d // 4) * 4)))
    pb = -(-c // target)
    pb = max(1, min(max(unit, cap // unit * unit), -(-pb // unit) * unit))
    warps = min(_C["kExtMaxWarps"], max(1, -(-m // _C["kExtWarpDirs"])))
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
    nblk = plan["nblk"] if want_z or moments is not None or dirs is not None else 0
    nm = d + d * (d + 1) // 2
    scratch = torch.empty(max(1, nblk * (4 * m + nm)), dtype=torch.float32, device=dev)
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
            _lib.ptr(scratch), scratch.data_ptr() + 4 * nblk * (2 * m + nm),
            _lib.ptr(SXo), _lib.ptr(z), *(_lib.ptr(t) for t in mo), *(_lib.ptr(t) for t in e),
            _lib.stream_ptr(dev),
        ),
        "repro_sweep",
    )
    LAUNCHES += 1
    PATH_LAUNCHES["wide" if D > _lib.CUDA_CONSTANTS["sweep.cu"]["kSlabCols"] else "narrow"] += 1
    return SXo, z, ext, out_moments
