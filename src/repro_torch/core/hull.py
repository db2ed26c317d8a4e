"""Convex-hull / ε-kernel approximation (Blum, Har-Peled, Raichel 2019),
ported from ``repro.core.hull``.

The paper stabilizes the negative-log part f3 by force-including the extreme
points of {a'_ij} (paper Lemma 2.3 / Algorithm 2). Two primitives, both on
the extremes kernel (``kernels.extremes.directional_extremes``; its plain
version for a CPU tensor):

  * ``greedy_hull_projection`` — the paper's Algorithm 2: Frank-Wolfe style
    greedy projection of a query q onto conv(P), returning the approximate
    nearest hull point and the support (extremal) indices it touched.
  * ``epsilon_kernel_indices`` — selects k extremal points by directional
    queries argmax_i ⟨p_i, v⟩ over a spread of directions (random + PCA).

The extremes kernel takes points of any d (a template body up to 16
coordinates, a wide body beyond), as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, to_tensor
from repro_torch.kernels.extremes import directional_extremes

__all__ = [
    "greedy_hull_projection",
    "epsilon_kernel_indices",
    "hull_directions",
    "hull_distance",
    "hull_normals",
    "stable_first_unique",
]


def greedy_hull_projection(P, q, eps: float = 1e-2, max_iter: int = 64, *, device=None):
    """Algorithm 2 of the paper (Blum et al. 2019 sparse hull approximation).

    Greedily walks from the closest point of P toward q, each step moving to
    the best point on the segment [t, p*] where p* is extremal in direction
    (q − t), found by the extremes kernel (one direction a launch). Exactly
    ``max_iter`` steps, as the reference's ``lax.scan``: once ‖q − t‖ < eps
    t stays fixed and the step records −1, by masks on the device (no host
    read a step). P is float32, as the kernel's; q is cast to it. Returns
    tensors ``(t (d,), support (max_iter + 1,) int64 with the start point
    first, dists (max_iter,))``."""
    P = to_tensor(P, torch.float32, resolve_device(device)).contiguous()
    q = to_tensor(q, P.dtype, P.device)
    n = P.shape[0]
    i0 = torch.argmin(torch.sum(torch.square(P - q), dim=1))
    t = P[i0]
    support, dists = [i0], []
    for _ in range(max_iter):
        i_star = directional_extremes(P, (q - t)[None].contiguous(), n)[1][0].long()
        p = P[i_star]
        seg = p - t
        denom = torch.sum(torch.square(seg))
        alpha = torch.where(denom > 1e-30, torch.dot(q - t, seg) / torch.clamp(denom, min=1e-30),
                            torch.zeros_like(denom))
        alpha = torch.clamp(alpha, 0.0, 1.0)
        near = torch.linalg.norm(q - t) < eps
        t = torch.where(near, t, t + alpha * seg)
        support.append(torch.where(near, torch.full_like(i_star, -1), i_star))
        dists.append(torch.linalg.norm(q - t))
    support = torch.stack(support)
    dists = torch.stack(dists) if dists else torch.zeros(0, dtype=P.dtype, device=P.device)
    return t, support, dists


def hull_distance(P, q, eps: float = 1e-3, max_iter: int = 128, *, device=None) -> float:
    """Approximate distance from q to conv(P)."""
    t, _, _ = greedy_hull_projection(P, q, eps, max_iter, device=device)
    return float(torch.linalg.norm(to_tensor(q, t.dtype, t.device) - t))


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


def _spread_directions(P: np.ndarray, m: int, *, normals=None,
                       generator: torch.Generator | None = None) -> np.ndarray:
    """Random unit directions + principal axes of the centered point cloud
    (its covariance in float32 numpy, as the reference computes it)."""
    Pc = P - P.mean(axis=0)
    cov = Pc.T @ Pc / max(P.shape[0], 1)
    return hull_directions(cov, m, normals=normals, generator=generator)


def stable_first_unique(cand: np.ndarray, k: int | None = None) -> np.ndarray:
    """First k distinct values of ``cand`` in order of first occurrence
    (all of them when ``k`` is None)."""
    uniq, first = np.unique(cand, return_index=True)
    order = np.argsort(first, kind="stable")
    out = uniq[order]
    return (out if k is None else out[:k]).astype(np.int64)


def epsilon_kernel_indices(
    P,
    k: int,
    *,
    oversample: int = 4,
    dirs=None,
    normals=None,
    generator: torch.Generator | None = None,
    device=None,
) -> np.ndarray:
    """Select ≤ k extremal (hull) indices of P via directional queries.

    The net is ``dirs`` when given, else ``max(oversample·k, 8)`` random
    unit directions (``normals``, the reference's ``jax.random.normal``
    draws in parity tests, or drawn from ``generator``) plus the ±principal
    axes of P's covariance. The extremes kernel scores P against the net;
    the candidates are every direction's argmax, then every argmin, deduped
    in first-occurrence order. n ≤ k returns ``arange(n)``.

    The kernel scores in float32, so a float64 ``dirs`` is rounded to
    float32 first, where the reference's numpy product scores it in
    float64: ids can differ only between points whose scores tie within
    float32 rounding."""
    P_np = np.asarray(P.detach().cpu() if isinstance(P, torch.Tensor) else P, dtype=np.float32)
    n = P_np.shape[0]
    dev = resolve_device(device)
    if n <= k:
        return np.arange(n)
    if dirs is None:
        if normals is None and generator is None:
            raise ValueError("epsilon_kernel_indices requires dirs, normals or generator")
        dirs = _spread_directions(P_np, max(oversample * k, 8), normals=normals,
                                  generator=generator)
    Pt = torch.as_tensor(P_np, device=dev)
    _, imax, _, imin = directional_extremes(Pt, to_tensor(dirs, torch.float32, dev).contiguous())
    cand = torch.cat([imax, imin]).cpu().numpy().astype(np.int64)
    return stable_first_unique(cand, k)
