"""Fused one-pass sweep wrapper on the CUDA kernel (``csrc/sweep.cu``) for a
CUDA tensor, on ``ref.py`` for a CPU tensor.

The kernel emits block-local deltas — dSX, the moment deltas and chunk-local
extremes — and this wrapper folds the deltas into the carried state, so the
engines' state layouts are those of the unfused formulation. The kernel is
float32 only and refuses a float64 sketch. Validity is a count of valid
points (``n_valid``), scaled by the r P rows of each point; rows past it are
never extreme, while the sketch, z and moments take every row given (the
caller zeroes a padding row's √w).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.sweep.ref import fused_sweep_ref

__all__ = ["fused_sweep_update", "LAUNCHES"]

MAX_D = 64
MAX_DP = 16
POINTS_PER_CTA = 128
MAX_SMEM = 232448  # bytes of shared memory an H100 CTA may opt in to
LAUNCHES = 0


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
    if D > MAX_D or d > MAX_DP:
        raise ValueError(f"the sweep kernel supports D ≤ {MAX_D} and d ≤ {MAX_DP}")
    lib = _lib.lib()
    smem = lib.repro_sweep_smem_bytes(D, sk, int(P is not None), r, d)
    if smem > MAX_SMEM:
        raise ValueError(
            f"sketch {sk} × D {D} needs {smem} B of shared memory per CTA, "
            f"above the H100's {MAX_SMEM}"
        )
    rows = rows.to(torch.int32).contiguous()
    signs = signs.to(torch.float32).contiguous()
    _lib.require_cuda(SX, X, P, sw, rows, signs, dirs, omega)
    dev = X.device
    m = 0 if dirs is None else dirs.shape[0]
    q = 0 if omega is None else omega.shape[1]
    nblk = -(-c // POINTS_PER_CTA)
    nm = d + d * (d + 1) // 2
    fs = torch.empty(max(1, nblk * (sk * D + nm + 2 * m)), dtype=torch.float32, device=dev)
    iscr = torch.empty(max(1, 2 * nblk * m), dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dsx = torch.empty((sk, D), **f32)
    z = torch.empty((c, q if omega is not None else D), **f32) if want_z else None
    ds1 = ds2 = None
    if moments is not None:
        ds1, ds2 = torch.empty(d, **f32), torch.empty((d, d), **f32)
    ext = None
    if dirs is not None:
        ext = (
            torch.empty(m, **f32), torch.empty(m, dtype=torch.int32, device=dev),
            torch.empty(m, **f32), torch.empty(m, dtype=torch.int32, device=dev),
        )
    e = ext if ext is not None else (None,) * 4
    nv = c if n_valid is None else int(n_valid)
    _lib.check(
        lib.repro_sweep(
            _lib.ptr(X), c, D, _lib.ptr(sw), _lib.ptr(rows), _lib.ptr(signs),
            _lib.ptr(P), r, d, nv, _lib.ptr(dirs), m, _lib.ptr(omega), q, sk,
            _lib.ptr(fs), _lib.ptr(iscr), _lib.ptr(dsx), _lib.ptr(z),
            _lib.ptr(ds1), _lib.ptr(ds2), *(_lib.ptr(t) for t in e),
            _lib.stream_ptr(dev),
        ),
        "repro_sweep",
    )
    LAUNCHES += 1
    out_moments = None
    if moments is not None:
        out_moments = (moments[0] + ds1, moments[1] + ds2)
    return SX + dsx, z, ext, out_moments
