"""Gram wrapper: G = acc + (√w·X)ᵀ(√w·X) on the CUDA kernel
(``csrc/gram.cu``: the cluster body for D ≤ 64 and the tiled body up to
TILED_MAX_D, one launch each; the large body above, any D, two launches, X
padded to a multiple of 4 columns) for a CUDA tensor, on ``ref.py`` for a
CPU tensor."""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.gram.ref import gram_ref

_C = _lib.CUDA_CONSTANTS["gram.cu"]
SMALL_MAX_D = _C["kMaxD"]  # the cluster body's limit; above it the tiled body
TILED_MAX_D = _C["kWideMaxD"]  # the tiled body's (J = 20 at degree 6); above it the large body
LAUNCHES = 0
PATH_LAUNCHES = {"cluster": 0, "tiled": 0, "large": 0}
_TICKETS: dict = {}  # (device index, stream) → the tiled body's kWideCluster int32 tickets


def tiled_plan(D: int) -> tuple[int, list[tuple[int, int, int, int]]]:
    """The tiled body's warps for D (64 < D ≤ TILED_MAX_D), as ``csrc/gram.cu``'s
    ``make_tiled_plan`` builds them on the host: ``(W, runs)``, each run
    (i0, j0, split, cnt) of W tiles of 16×8 (tiles q < split are (i0, j0 +
    q), the rest (i0 + 1, 2(i0 + 1) + q − split); q ≥ cnt pad the run). It
    reads the built library, so it needs the CUDA toolkit."""
    out = np.zeros(2 + 4 * _C["kWideMaxGroups"], dtype=np.int32)
    _lib.check(_lib.lib().repro_gram_tiled_plan(D, out.ctypes.data), "repro_gram_tiled_plan")
    runs, W = int(out[0]), int(out[1])
    return W, [tuple(int(v) for v in out[2 + 4 * k:6 + 4 * k]) for k in range(runs)]


# the large plan's model of the card: CTAs of the large body at once (those
# an SM holds, on the H100's 132 SMs), and a CTA's cost beyond its stages
# (its first loads and its store of a tile's pairs), in stage times. At n
# 16,384, D 2,048 it picks 9 splits; scripts/torch_plan_timings.py times 1–24
LARGE_SLOTS = 132 * _C["kLargeCtasPerSm"]
LARGE_CTA_STAGES = 5


@functools.lru_cache(maxsize=256)
def large_plan(n: int, D: int) -> tuple[int, int]:
    """The large body's launch for D > TILED_MAX_D: ``(tiles, splits)``,
    the nb(nb+1)/2 upper tiles of kLargeTile² (nb = ⌈D/kLargeTile⌉) and the
    row spans (whole kLargeStageRows stages, at most kLargeMaxSplits): the
    fewest splits among those that take the least time in waves of
    LARGE_SLOTS CTAs, each CTA its span's stages and LARGE_CTA_STAGES more.
    A pure function of (n, D), so the summation order is too."""
    nb = -(-D // _C["kLargeTile"])
    tiles = nb * (nb + 1) // 2
    rows = _C["kLargeStageRows"]
    best, splits = None, 1
    for s in range(1, _C["kLargeMaxSplits"] + 1):
        span = -(-(-(-n // s)) // rows)  # stages a span: ⌈⌈n/s⌉ / rows⌉
        if s > 1 and span * rows * (s - 1) >= n:
            break  # the last span would be empty
        cost = -(-tiles * s // LARGE_SLOTS) * (span + LARGE_CTA_STAGES)
        if best is None or cost < best:
            best, splits = cost, s
    return tiles, splits


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(_C["kWideCluster"], dtype=torch.int32, device=device)
    return t


def gram_matrix(
    X: torch.Tensor,
    sw: torch.Tensor | None = None,
    *,
    acc: torch.Tensor | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """X (n, D) f32, sw (n,) f32 square-root weights or None, acc (D, D) f32
    or None → acc + (√w·X)ᵀ(√w·X), (D, D) f32, a new tensor. The chunk's
    sum is formed first and acc added last, so the result has the bits of
    ``acc + gram_matrix(X, sw)``."""
    global LAUNCHES
    if _lib.resolve_backend(backend, X, "gram") == "torch":
        return gram_ref(X, sw, acc=acc)
    if any(t is not None and t.dtype != torch.float32 for t in (X, sw, acc)):
        raise ValueError("the gram kernel is float32 only")
    n, D = X.shape
    if sw is not None and sw.shape != (n,):
        raise ValueError(f"sw must be ({n},), got {tuple(sw.shape)}")
    if acc is not None and acc.shape != (D, D):
        raise ValueError(f"acc must be ({D}, {D}), got {tuple(acc.shape)}")
    _lib.require_cuda(X, sw, acc)
    path = "cluster" if D <= SMALL_MAX_D else ("tiled" if D <= TILED_MAX_D else "large")
    if path == "large" and D % 4:
        # the large body stages whole 16-byte pieces of a row: zero columns
        # pad D to a multiple of 4 (an entry of G reads its own two columns)
        pad = 4 - D % 4
        acc = None if acc is None else torch.nn.functional.pad(acc, (0, pad, 0, pad))
        return gram_matrix(torch.nn.functional.pad(X, (0, pad)), sw, acc=acc)[:D, :D].contiguous()
    # the kernel copies X and sw 16 bytes at a time
    X = X if X.data_ptr() % 16 == 0 else X.clone()
    sw = sw if sw is None or sw.data_ptr() % 16 == 0 else sw.clone()
    G = torch.empty((D, D), dtype=torch.float32, device=X.device)
    stream = _lib.stream_ptr(X.device)
    scratch = tickets = None
    splits = 0
    if path == "tiled":
        scratch = torch.empty(_C["kWideScratchFloats"], dtype=torch.float32, device=X.device)
        tickets = _tickets(X.device, stream)
    elif path == "large":
        tiles, splits = large_plan(n, D)
        scratch = torch.empty(splits * tiles * 2 * _C["kLargeTile"] ** 2, dtype=torch.float32,
                              device=X.device)
    _lib.check(
        _lib.lib().repro_gram(
            _lib.ptr(X), _lib.ptr(sw), n, D, _lib.ptr(acc), _lib.ptr(G), _lib.ptr(scratch),
            _lib.ptr(tickets), splits, stream,
        ),
        "repro_gram",
    )
    LAUNCHES += 1
    PATH_LAUNCHES[path] += 1
    return G
