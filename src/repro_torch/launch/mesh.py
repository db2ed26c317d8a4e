"""Mesh construction for the launchers — the port of ``repro.launch.mesh``.

Two kinds of mesh, by caller:

  * the coreset path (``core.distributed_coreset``, ``launch/train_mctm.py``,
    ``launch/dryrun_coreset.py``) takes a ``DataMesh``: one rank a data
    shard, the hand-written fixed-order fold between them;
  * the LM's sharded step and dry run (``train.shard_train_step``,
    ``launch/dryrun.py``) take a ``torch.distributed.device_mesh.DeviceMesh``
    whose dimension names are the reference's axes, ``("data", "model")``
    or ``("pod", "data", "model")``, for DTensor.

``make_host_mesh`` gives the LM's ``DeviceMesh`` ``("data", "model")`` of
``world/model × model`` over the ranks this process was launched with
(``launch.stages.data_mesh``, whose ``DataMesh`` is the coreset path's);
``device_mesh`` makes one of any ``DataMesh`` with a group. ``data_axes``
names the axes that carry data rows; ``host_gather`` pulls row-sharded
host results together. Rank 0 of the reference's 256- and 512-chip meshes,
in an in-process fake world for tracing on the CPU: ``make_production_mesh``
is the coreset dry run's ``DataMesh`` view, ``make_production_device_mesh``
the LM dry run's ``DeviceMesh``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.mesh import DataMesh, host_gather  # noqa: F401  (re-export)

__all__ = ["make_production_mesh", "make_production_device_mesh", "make_host_mesh", "data_axes",
           "host_gather", "device_mesh", "close_fake_world"]

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> DataMesh:
    """The ``DataMesh`` view of rank 0 of the reference's production meshes
    that the coreset dry run (``launch/dryrun_coreset.py``) traces on: 16
    data shards (axes ``("data",)``, 16×16 = 256 chips) or 32 (``("pod",
    "data")``, 2×16×16 = 512), the model axis of 16 in ``chips`` only. It
    never runs a collective for real; ``close()`` leaves it."""
    from repro_torch.distributed.mesh import fake_mesh

    shards = 32 if multi_pod else 16  # × the model axis of 16 = 512 or 256 chips
    return fake_mesh(shards, device="cpu", axes=PRODUCTION[multi_pod][1][:-1],
                     chips=16 * shards)


def make_production_device_mesh(*, multi_pod: bool = False):
    """Rank 0 of the reference's production mesh, 16×16 ``("data",
    "model")`` or 2×16×16 ``("pod", "data", "model")``, as the
    ``DeviceMesh`` of an in-process fake world of 256 or 512 ranks (the
    process's default group, which ``close_fake_world()`` leaves): the LM
    dry run (``launch/dryrun.py``) traces DTensors on it, on the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = PRODUCTION[multi_pod]
    world = int(torch.tensor(shape).prod())
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} process group is already the default "
                           f"group; the fake world of {world} needs its place")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        return init_device_mesh("cpu", shape, mesh_dim_names=axes)
    except BaseException:
        close_fake_world()
        raise


def close_fake_world() -> None:
    """Tear down the process's default group if it is a fake world (the
    LM dry run's); a real group is left to its maker."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def device_mesh(mesh: DataMesh, model: int = 1):
    """The ``DeviceMesh`` ``("data", "model")`` of ``world/model × model``
    over ``mesh``'s ranks (row-major: rank r is (r // model, r % model)) on
    its device type. The mesh's process group must be the default one (a
    world of 1 too: ``init_mesh`` makes it)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise ValueError("a DeviceMesh needs an initialised process group (init_mesh)")
    if model < 1 or mesh.world % model:
        raise ValueError(f"a world of {mesh.world} is not divisible by model = {model}")
    ranks = torch.arange(mesh.world).reshape(mesh.world // model, model)
    return DeviceMesh(mesh.device.type, ranks, mesh_dim_names=("data", "model"))


def make_host_mesh(model: int = 1, *, backend: str | None = None, device=None):
    """The ``DeviceMesh`` ``("data", "model")`` of ``world/model × model``
    over the ranks this process was launched with (``data_mesh``: under
    ``torchrun`` its world; otherwise a world of 1 on ``device``, None →
    CUDA, whose process group this call makes in memory unless one is the
    default already): the LM's sharded step's mesh, at any ``model``."""
    import torch.distributed as dist

    from repro_torch.launch.stages import data_mesh

    mesh = data_mesh(backend=backend, device=device)
    if model < 1 or mesh.world % model:
        raise ValueError(f"a world of {mesh.world} is not divisible by model = {model}")
    if not dist.is_initialized():  # a world of 1
        backend = backend or ("nccl" if mesh.device.type == "cuda" else "gloo")
        kwargs = {"device_id": mesh.device} if backend == "nccl" else {}
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                **kwargs)
    return device_mesh(mesh, model)


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that shard data rows: a ``DataMesh``'s own (("data",)
    unless built with others, such as ("pod", "data")); a ``DeviceMesh``'s
    ("pod", "data") when it has a pod axis, ("data",) otherwise. Feed the
    tuple to ``DistributedScoringEngine(axis=...)`` so a script works
    unchanged on any mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return ("pod", "data") if "pod" in names else ("data",)
    return mesh.axes
