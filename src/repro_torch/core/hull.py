"""Hull direction net and candidate dedup — the part of ``repro.core.hull``
the Algorithm 1 path runs (``greedy_hull_projection`` and
``epsilon_kernel_indices`` are not ported yet)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["hull_directions", "hull_normals", "stable_first_unique"]


def hull_normals(m: int, d: int, generator: torch.Generator | None = None) -> np.ndarray:
    """The net's (m, d) standard-normal draws, f32, from a CPU generator."""
    return torch.randn((m, d), generator=generator, dtype=torch.float32).numpy()


def hull_directions(
    cov: np.ndarray,
    m: int,
    *,
    normals=None,
    generator: torch.Generator | None = None,
) -> np.ndarray:
    """Direction net: m random unit directions + ±principal axes of ``cov``.

    ``normals`` (m, d) are the random draws (the reference's
    ``jax.random.normal`` draws in parity tests); without them they come
    from ``generator``.
    """
    d = cov.shape[0]
    g = np.array(normals if normals is not None else hull_normals(m, d, generator),
                 dtype=np.float32)
    if g.shape != (m, d):
        raise ValueError(f"normals must be ({m}, {d}), got {g.shape}")
    g /= np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-12)
    _, V = np.linalg.eigh(cov)
    return np.concatenate([g, V.T, -V.T], axis=0)


def stable_first_unique(cand: np.ndarray, k: int | None = None) -> np.ndarray:
    """First k distinct values of ``cand`` in order of first occurrence
    (all of them when ``k`` is None)."""
    uniq, first = np.unique(cand, return_index=True)
    order = np.argsort(first, kind="stable")
    out = uniq[order]
    return (out if k is None else out[:k]).astype(np.int64)
