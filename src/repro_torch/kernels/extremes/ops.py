"""Directional-extremes wrapper on the CUDA kernel (``csrc/extremes.cu``)
for a CUDA tensor, on ``ref.py`` for a CPU tensor. Row validity is a count:
rows at or past ``n_valid`` are never extreme."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.extremes.ref import directional_extremes_ref

MAX_DP = 16
ROWS_PER_CTA = 512
LAUNCHES = 0


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
    if dirs.shape[1] != d or not 1 <= d <= MAX_DP or m == 0:
        raise ValueError(f"expected P (rows, d ≤ {MAX_DP}) and dirs (m ≥ 1, d), got {tuple(P.shape)}, {tuple(dirs.shape)}")
    nv = rows if n_valid is None else int(n_valid)
    _lib.require_cuda(P, dirs)
    dev = P.device
    nblk = -(-rows // ROWS_PER_CTA)
    fs = torch.empty(max(1, 2 * nblk * m), dtype=torch.float32, device=dev)
    iscr = torch.empty(max(1, 2 * nblk * m), dtype=torch.int32, device=dev)
    vmax = torch.empty(m, dtype=torch.float32, device=dev)
    vmin = torch.empty_like(vmax)
    imax = torch.empty(m, dtype=torch.int32, device=dev)
    imin = torch.empty_like(imax)
    _lib.check(
        _lib.lib().repro_extremes(
            _lib.ptr(P), rows, d, nv, _lib.ptr(dirs), m, _lib.ptr(fs), _lib.ptr(iscr),
            _lib.ptr(vmax), _lib.ptr(imax), _lib.ptr(vmin), _lib.ptr(imin),
            _lib.stream_ptr(dev),
        ),
        "repro_extremes",
    )
    LAUNCHES += 1
    return vmax, imax, vmin, imin
