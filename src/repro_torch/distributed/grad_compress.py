"""Gradient compression with error feedback — the port of
``repro.distributed.grad_compress``.

``compress_and_average``: explicit data-parallel gradient averaging where
each all-reduce ships an int8 payload (``collectives.psum_quantized``); the
quantization residual is carried in an error-feedback buffer, so the
*accumulated* update is unbiased (Karimireddy et al. 2019). ``topk_sparsify``
keeps the largest entries of a gradient. Trees are dicts, lists or tuples of
tensors (``utils.tree``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed.collectives import axis_group, psum_quantized
from repro_torch.utils.tree import tree_leaves, tree_like, tree_map

PyTree = Any

__all__ = ["init_error_state", "compress_and_average", "topk_sparsify"]


def init_error_state(params: PyTree) -> PyTree:
    """Float32 zeros of each leaf's shape, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def topk_sparsify(g: torch.Tensor, frac: float = 0.01) -> torch.Tensor:
    """Keep the top ``frac`` fraction of entries by magnitude (rest zeroed;
    entries tied with the k-th largest magnitude are kept too)."""
    flat = g.reshape(-1)
    k = max(int(flat.shape[0] * frac), 1)
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(g) >= thresh, g, torch.zeros((), dtype=g.dtype, device=g.device))


def compress_and_average(
    grads: PyTree,
    error: PyTree,
    mesh,
    axis: str = "data",
    *,
    bits: int = 8,
) -> tuple[PyTree, PyTree]:
    """(avg_grads, new_error): int8 all-reduce with error feedback.

    ``grads`` are this rank's data-parallel gradients (the same shapes on
    every rank, different values), ``error`` its residual buffers; returns
    the average over the axis's ranks (the same on every rank) and the
    updated residual: what the rank meant to send less what the wire
    carried. Collective: every rank of the axis calls it."""
    _, n, _ = axis_group(mesh, axis)
    qmax = 2 ** (bits - 1) - 1

    def one(g, e):
        corrected = g.float() + e
        avg = psum_quantized(corrected, mesh, axis, bits=bits) / n
        # the scale the wire used, from the max all-reduce psum_quantized made
        scale = torch.clamp(_axis_max(torch.max(torch.abs(corrected)), mesh, axis) / qmax,
                            min=1e-12)
        sent = torch.clamp(torch.round(corrected / scale), -qmax, qmax) * scale
        return avg, corrected - sent

    outs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error), strict=True)]
    return tree_like(grads, [a for a, _ in outs]), tree_like(grads, [e for _, e in outs])


def _axis_max(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    import torch.distributed as dist

    from repro_torch.distributed.collectives import _all_reduce

    group, n, _ = axis_group(mesh, axis)
    x = x.float()
    return _all_reduce(x, group, dist.ReduceOp.MAX) if n > 1 else x
