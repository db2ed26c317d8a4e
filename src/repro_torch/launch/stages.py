"""Shared launcher stages — the port of ``repro.launch.stages``.

The corpus → coreset data-reduction stage: score the examples once with
Algorithm 1 (``data.pipeline.CoresetSelector``, on the card's kernels) and
hand the trainer a ``sample_fn`` over the weighted subset. The mesh stage
(``data_mesh``) is not ported yet (ROADMAP Queue A 9).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.data.pipeline import CoresetSelector, subset_loader

__all__ = ["coreset_subset_loader"]


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
