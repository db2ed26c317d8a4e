"""Shared launcher stages — the port of ``repro.launch.stages``.

The corpus → coreset data-reduction stage: score the examples once with
Algorithm 1 (``data.pipeline.CoresetSelector``, on the card's kernels) and
hand the trainer a ``sample_fn`` over the weighted subset; and ``data_mesh``,
the mesh every data-sharded stage uses (``DistributedScoringEngine``, the
sharded fits, the streamed evaluator).
"""
from __future__ import annotations

import os
from typing import Callable

import torch

from repro_torch.data.pipeline import CoresetSelector, subset_loader
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import DataMesh, init_mesh

__all__ = ["coreset_subset_loader", "data_mesh"]


def data_mesh(axis: str = "data", *, backend: str | None = None, device=None) -> DataMesh:
    """The mesh of the ranks this process was launched with, one data axis.

    Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) the process
    joins its world through ``env://``: rank ``RANK`` on ``cuda:LOCAL_RANK``
    over NCCL, or over gloo when the caller names it (``backend="gloo"``; a
    CPU world must). Otherwise a world of 1 on ``device`` (None → CUDA),
    with no process group."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return DataMesh(device=resolve_device(device), axes=(axis,))
    rank = int(os.environ["RANK"])
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", rank)))
    if backend is None:
        if dev.type != "cuda":
            raise ValueError("a CPU world runs on gloo, which the caller must name "
                             "(backend='gloo')")
        backend = "nccl"
    return init_mesh(rank, world, backend=backend, device=resolve_device(dev),
                     init_method="env://", axes=(axis,))


def coreset_subset_loader(
    data: dict,
    featurize: Callable,
    *,
    k: int,
    batch: int,
    generator: torch.Generator | None = None,
    plan: dict | None = None,
    method: str = "l2-hull",
    examples_key: str = "tokens",
    mesh=None,
    axis="data",
    sketch_size: int = 0,
    chunk_size: int | None = None,
    device=None,
):
    """The generic coreset data-reduction stage: score ``data[examples_key]``
    once with ``CoresetSelector`` (optionally through the one-pass sketched
    strategy) and return a ``sample_fn`` over the weighted subset, coreset
    weights attached per example. The selection's draws come from ``plan``
    (the reference's, in parity tests) or ``generator``."""
    kwargs = {} if chunk_size is None else {"chunk_size": chunk_size}
    sel = CoresetSelector(featurize=featurize, method=method, mesh=mesh, axis=axis,
                          sketch_size=sketch_size, device=device, **kwargs)
    subset = sel.select(data[examples_key], k=k, generator=generator, plan=plan)
    return subset_loader(data, subset, batch)
