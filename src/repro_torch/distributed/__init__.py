"""Distributed execution of the port over ``torch.distributed`` — the
port's counterpart of ``repro.distributed`` and of the meshes
``repro.core.distributed_coreset`` runs on:

  * ``mesh.py``: ``DataMesh``, the fixed-order fold, the host exchange,
    spawned worlds (the coreset path);
  * ``sharding.py``: the logical-axis sharding rules resolved to specs and
    DTensor placements on a ``DeviceMesh`` (the LM's sharded step and dry
    run);
  * ``collectives.py``, ``grad_compress.py``, ``pipeline_parallel.py``:
    the hand-written ring matmuls, the int8 all-reduce, gradient
    compression with error feedback, and the GPipe forward, over the
    process group of a mesh axis.
"""
from repro_torch.distributed.mesh import (
    BACKENDS,
    DataMesh,
    FakeWorldMesh,
    RankExit,
    axis_tuple,
    fake_mesh,
    host_gather,
    init_mesh,
    kv_allreduce,
    run_world,
)
from repro_torch.distributed.sharding import (
    ShardingRules,
    batch_specs,
    default_rules,
    replicated,
    resolve_spec,
    resolve_tree,
)

__all__ = [
    "BACKENDS",
    "DataMesh",
    "FakeWorldMesh",
    "RankExit",
    "axis_tuple",
    "fake_mesh",
    "host_gather",
    "init_mesh",
    "kv_allreduce",
    "run_world",
    "ShardingRules",
    "batch_specs",
    "default_rules",
    "replicated",
    "resolve_spec",
    "resolve_tree",
]
