"""ℓ2 leverage scores for the MCTM block matrix B (paper Section 2, part 1),
ported from ``repro.core.leverage``.

B ∈ R^{nJ×dJ²} repeats the row b_i = (a_{i1},…,a_{iJ}) ∈ R^{dJ} in J
disjoint column blocks, so BᵀB = blockdiag(ÃᵀÃ ×J) and the leverage of
B-row (i, j) is that of Ã-row i: every function here scores the small
matrix Ã (n, J·d).

Variants (the paper's Table 2 baselines): exact via QR
(``leverage_scores_qr``), exact via Gram + eigh pseudo-inverse
(``leverage_scores_gram``), CountSketch (``sketched_leverage``), ridge
(``ridge_leverage_scores``) and root (``root_leverage_scores``).

Each takes X as a tensor or array and runs on ``device`` (None → CUDA,
which must exist). float32 X computes in float32; float64 X in float64, as
the reference does under x64. The float32 Gram XᵀX is formed by the gram
kernel (``kernels.gram.gram_matrix``, any D), so these scores share the
scoring engine's summation order: the degree-6 l2 leverage moves by up to
~3e-3 under another float32 order. In float64 the Gram is ``X.T @ X``
(``torch.mm``), the reference's plain product: a rule of the dtype, not a
fallback (the kernel is float32 only).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scoring import (
    DEFAULT_CHUNK, _spectrum_inverse, countsketch_add, sketch_plan,
)
from repro_torch.device import resolve_device, to_tensor
from repro_torch.kernels.gram import gram_matrix
from repro_torch.kernels.sweep import fused_sweep_update

__all__ = [
    "flatten_features",
    "block_B_matrix",
    "leverage_scores_qr",
    "leverage_scores_gram",
    "leverage_from_gram",
    "sketched_leverage",
    "ridge_leverage_scores",
    "root_leverage_scores",
]


def flatten_features(A):
    """(n, J, d) basis tensor → Ã ∈ (n, J·d) with rows b_i."""
    return A.reshape(A.shape[0], -1)


def block_B_matrix(A: np.ndarray) -> np.ndarray:
    """Explicit paper matrix B ∈ R^{nJ × dJ²} (tests / small n only).

    Row (i, j) carries b_i in column block j: B[(i·J)+j, j·dJ:(j+1)·dJ] = b_i.
    """
    A = np.asarray(A)
    n, J, d = A.shape
    b = A.reshape(n, J * d)
    B = np.zeros((n * J, J * J * d), dtype=A.dtype)
    for i in range(n):
        for j in range(J):
            B[i * J + j, j * J * d : (j + 1) * J * d] = b[i]
    return B


def _input(X, device) -> torch.Tensor:
    """X on ``device``, float64 kept, any other dtype as float32."""
    X = to_tensor(X, device=resolve_device(device))
    return X if X.dtype == torch.float64 else X.to(torch.float32)


def _gram(X: torch.Tensor) -> torch.Tensor:
    """XᵀX: the gram kernel (its plain version on the CPU) for float32,
    ``torch.mm`` for float64 (see the module doc)."""
    if X.dtype == torch.float32:
        return gram_matrix(X.contiguous())
    return X.T @ X


def leverage_scores_qr(X, *, device=None) -> torch.Tensor:
    """Exact leverage scores via thin QR: u_i = ||Q_i||²."""
    Q, _ = torch.linalg.qr(_input(X, device))
    return torch.sum(torch.square(Q), dim=1)


def leverage_from_gram(X, G, rcond: float = 1e-6, *, device=None) -> torch.Tensor:
    """u_i = X_i G⁺ X_iᵀ given a (possibly accumulated) Gram G = XᵀX.

    The eigendecomposition runs in G's own dtype; modes at or below
    ``rcond``·max|w| are dropped, the rule ``scoring._spectrum_inverse``
    applies to the engine's Gram. ``rcond`` must sit above the f32
    summation noise floor (~1e-8·λmax): an exactly-null mode surfaces from
    eigh at ±O(1e-8)·λmax, and a threshold below that would include it with
    an enormous 1/λ weight, depending on nothing but accumulation order.

    The (D, D) eigh runs on the host for every device, so the card and the
    CPU share one eigensolver: the degree-6 basis keeps a genuine mode at
    1.3e-6·λmax, just above the threshold, and the card's float32 eigh
    (cuSOLVER) dropped it where the host's keeps it (NVIDIA H100, n =
    250,001, PERF.md §6)."""
    X = _input(X, device)
    G = to_tensor(G, device="cpu")
    w, V = torch.linalg.eigh(G)
    inv = torch.as_tensor(_spectrum_inverse(w.numpy(), ridge_reg=0.0, rcond=rcond),
                          device=X.device)
    P = X @ V.to(X.device, X.dtype)
    return torch.sum(torch.square(P) * inv.to(P.dtype), dim=1)


def leverage_scores_gram(X, *, device=None) -> torch.Tensor:
    X = _input(X, device)
    return leverage_from_gram(X, _gram(X), device=X.device)


def sketched_leverage(
    X,
    sketch_size: int,
    *,
    plan=None,
    generator: torch.Generator | None = None,
    chunk_size: int = DEFAULT_CHUNK,
    device=None,
) -> torch.Tensor:
    """Constant-factor approximate leverage scores via CountSketch (Woodruff
    2014, Thm 2.13): u_i ≈ X_i (SXᵀSX)⁺ X_iᵀ.

    ``plan`` = (rows (n,) in [0, sketch_size), signs (n,) ±1), the
    reference's ``randint``/``rademacher`` draws in parity tests; without
    it from ``generator`` (``scoring.sketch_plan``). SX is accumulated
    ``chunk_size`` rows at a time, in X's dtype: on the sweep kernel (no P
    rows, no z) for float32 X, by ``scoring.countsketch_add`` for float64:
    a rule of the dtype, as for the Gram. Both add each bucket's rows in
    ascending order, without atomics."""
    X = _input(X, device)
    n, D = X.shape
    dev = X.device
    if plan is None:
        if generator is None:
            raise ValueError("sketched_leverage requires generator or plan")
        rows, signs = sketch_plan(n, sketch_size, generator=generator, device=dev)
    else:
        rows = to_tensor(plan[0], device=dev).to(torch.int32)
        signs = to_tensor(plan[1], torch.float32, dev)
        if rows.shape != (n,) or signs.shape != (n,):
            raise ValueError(f"plan rows/signs must be ({n},)")
        if n and (int(rows.min()) < 0 or int(rows.max()) >= sketch_size):
            raise ValueError(f"plan rows must lie in [0, {sketch_size})")
    SX = torch.zeros((sketch_size, D), dtype=X.dtype, device=dev)
    step = max(1, int(chunk_size))
    for lo in range(0, n, step):
        Xc, rc, sc = X[lo:lo + step], rows[lo:lo + step], signs[lo:lo + step]
        if X.dtype == torch.float64:
            SX = countsketch_add(SX, sc[:, None].to(X.dtype) * Xc, rc)
        else:
            sw = torch.ones(Xc.shape[0], dtype=torch.float32, device=dev)
            SX = fused_sweep_update(SX, Xc.contiguous(), None, sw, rc, sc, want_z=False)[0]
    return leverage_from_gram(X, SX.T @ SX, device=dev)


def ridge_leverage_scores(X, reg: float = 1.0, *, device=None) -> torch.Tensor:
    """u_i(λ) = X_i (XᵀX + λI)⁻¹ X_iᵀ (baseline ``ridge-lss``)."""
    X = _input(X, device)
    D = X.shape[1]
    G = _gram(X) + reg * torch.eye(D, dtype=X.dtype, device=X.device)
    sol = torch.linalg.solve(G, X.T)  # (D, n)
    return torch.sum(X * sol.T, dim=1)


def root_leverage_scores(X, *, device=None) -> torch.Tensor:
    """sqrt(u_i) scores (baseline ``root-l2``): flattens the sampling
    distribution."""
    return torch.sqrt(torch.clamp(leverage_scores_gram(X, device=device), min=0.0))
