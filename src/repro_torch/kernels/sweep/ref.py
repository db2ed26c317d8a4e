"""Plain PyTorch version of the fused one-pass sweep step: CountSketch
accumulation, optional moment accumulation, z emission and the directional
extremes of the derivative rows, as ``OnePassSketched`` runs them per chunk."""
from __future__ import annotations

import torch

from repro_torch.kernels.extremes.ref import directional_extremes_ref, fma_matmul


def fused_sweep_ref(
    SX, X, P, sw, rows, signs, *, dirs=None, omega=None, n_valid=None,
    moments=None, want_z: bool = True,
):
    """See ``ops.fused_sweep_update`` for the contract. Returns
    ``(SX', z, ext, moments')``; the sketch update is cast to SX's dtype.
    z = (√w·X)Ω is rounded as the kernel rounds it (``fma_matmul``)."""
    Xw = X * sw[:, None]
    SX = SX.index_add(0, rows.long(), (signs[:, None] * Xw).to(SX.dtype))
    out_moments = None
    if moments is not None:
        s1, s2 = moments
        out_moments = (s1 + P.sum(dim=0), s2 + P.T @ P)
    z = None
    if want_z:
        z = Xw if omega is None else fma_matmul(Xw, omega)
    ext = None
    if dirs is not None:
        r = P.shape[0] // X.shape[0]
        ext = directional_extremes_ref(P, dirs, None if n_valid is None else n_valid * r)
    return SX, z, ext, out_moments
