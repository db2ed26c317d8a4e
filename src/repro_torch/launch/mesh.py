"""Mesh construction for the launchers — the port of ``repro.launch.mesh``.

``make_host_mesh`` and ``data_axes`` are what a launch script needs to drive
the sharded coreset path (``core.distributed_coreset``): the mesh over the
ranks this process was launched with (``launch.stages.data_mesh``), and the
axes that carry the data rows. ``host_gather`` pulls row-sharded host results
together. ``make_production_mesh`` is rank 0 of the 256- and 512-chip meshes
the reference lowers for its dry run, as a fake world that the port's dry
run traces on.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import DataMesh, host_gather  # noqa: F401  (re-export)

__all__ = ["make_production_mesh", "make_host_mesh", "data_axes", "host_gather"]


def make_production_mesh(*, multi_pod: bool = False) -> DataMesh:
    """Rank 0's ``DataMesh`` of the reference's production meshes: 16×16
    (256 chips, 16 data shards, axes ``("data",)``) or 2×16×16 (512 chips,
    32 data shards, axes ``("pod", "data")``), the model axis of 16 not
    carried (model-parallel axes are the LM zoo's, ROADMAP Queue A 11). The
    world is an in-process fake (``distributed.fake_mesh``): it never runs a
    collective for real, so the mesh serves tracing (the dry run,
    ``launch/dryrun_coreset.py``), on the CPU where it traces; ``close()``
    leaves it."""
    from repro_torch.distributed.mesh import fake_mesh

    shards = 32 if multi_pod else 16  # × the model axis of 16 = 512 or 256 chips
    axes = ("pod", "data") if multi_pod else ("data",)
    return fake_mesh(shards, device="cpu", axes=axes, chips=16 * shards)


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
