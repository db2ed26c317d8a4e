"""GPipe-style pipeline parallelism over a "stage" group — the port of
``repro.distributed.pipeline_parallel``.

Layers are stacked (L, ...) and split into ``n_stages`` contiguous groups
(``split_stages``); rank s of the stage axis runs group s. The forward runs
the classic schedule: at tick t, stage s processes microbatch t − s and
passes its activations to stage s + 1 by send/recv (``batch_isend_irecv``
around the ring, as the reference's ``ppermute``): n_micro + n_stages − 1
ticks, bubble fraction (S − 1)/(M + S − 1). Every stage computes at every
tick, as the reference's batched body does; the last stage keeps the
microbatches it emits, and its outputs reach every stage by a sum of the
stages' outputs masked to the last one (the reference's one-hot ``psum``).
Under gloo a CUDA activation is staged through the host
(``collectives.py``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.collectives import _all_reduce, _ring_hop, axis_group
from repro_torch.utils.tree import tree_map

__all__ = ["pipeline_forward", "split_stages"]


def split_stages(layer_params, n_stages: int):
    """(L, ...) stacked layer params → (n_stages, L/n_stages, ...)."""

    def reshape(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"L={L} not divisible by {n_stages} stages")
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])

    return tree_map(reshape, layer_params)


def pipeline_forward(
    x_micro: torch.Tensor,
    stage_params,
    layer_fn: Callable,
    mesh,
    *,
    axis: str = "stage",
) -> torch.Tensor:
    """Run microbatches through the pipeline stages of ``mesh``'s ``axis``.

    x_micro: (n_micro, mb, S, D), the same on every stage. stage_params: a
    tree with leading (n_stages, L_per_stage, ...) (``split_stages``); this
    rank takes its own stage's slice. layer_fn: (layer_params_slice, x) →
    x, applied L_per_stage times. Returns the (n_micro, mb, S, D) outputs
    on every stage. Collective: every rank of the axis calls it."""
    import torch.distributed as dist

    group, n_stages, sid = axis_group(mesh, axis)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    params = tree_map(lambda p: p[sid], stage_params)
    leaves = []
    tree_map(leaves.append, params)
    n_layers = leaves[0].shape[0]

    def run_stage(x):
        for i in range(n_layers):
            x = layer_fn(tree_map(lambda p: p[i], params), x)
        return x

    buf = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype, device=x_micro.device)
    outputs = torch.zeros_like(x_micro)
    for t in range(ticks):
        # stage 0 ingests microbatch t (clamped, as the reference's index)
        x_in = x_micro[min(t, n_micro - 1)] if sid == 0 else buf
        y = run_stage(x_in)
        # the last stage emits microbatch t − (S − 1)
        if t - (n_stages - 1) >= 0 and sid == n_stages - 1:
            outputs[t - (n_stages - 1)] = y
        if n_stages > 1:
            (buf,) = _ring_hop([y], group, n_stages, sid)()
        else:
            buf = y
    if n_stages == 1:
        return outputs
    # the last stage's outputs on every stage (a sum of one-hot-masked outputs)
    has = float(sid == n_stages - 1)
    return _all_reduce(outputs * has, group, dist.ReduceOp.SUM)
