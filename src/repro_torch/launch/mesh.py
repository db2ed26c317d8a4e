"""Mesh construction for the launchers — the port of ``repro.launch.mesh``.

``make_host_mesh`` and ``data_axes`` are what a launch script needs to drive
the sharded coreset path (``core.distributed_coreset``): the mesh over the
ranks this process was launched with (``launch.stages.data_mesh``), and the
axes that carry the data rows. ``host_gather`` pulls row-sharded host results
together. ``make_production_mesh`` (the 256- and 512-chip meshes the
reference lowers for its dry run) waits for the dry run, ROADMAP Queue A 10.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import DataMesh, host_gather  # noqa: F401  (re-export)

__all__ = ["make_production_mesh", "make_host_mesh", "data_axes", "host_gather"]


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the production meshes feed the pod dry run (launch/dryrun_coreset.py), which is "
        "not ported yet (ROADMAP Queue A 10)")


def make_host_mesh(model: int = 1, *, backend: str | None = None, device=None) -> DataMesh:
    """The mesh over the ranks this process belongs to (``data_mesh``); the
    port carries data axes only, so ``model`` must be 1."""
    from repro_torch.launch.stages import data_mesh

    if model != 1:
        raise NotImplementedError("model-parallel axes are the LM zoo's (ROADMAP Queue A 11)")
    return data_mesh(backend=backend, device=device)


def data_axes(mesh: DataMesh) -> tuple[str, ...]:
    """The mesh axes that shard data rows (("data",) unless the mesh was
    built with others, such as ("pod", "data")). Feed the tuple to
    ``DistributedScoringEngine(axis=...)`` so a script works unchanged on
    any mesh."""
    return mesh.axes
