"""Data-parallel execution of the port over ``torch.distributed`` — the
port's counterpart of the meshes ``repro.distributed`` and
``repro.core.distributed_coreset`` run on (``mesh.py``: ``DataMesh``, the
fixed-order fold, the host exchange, spawned worlds).

The reference's LM parts of ``distributed/`` (sharding rules,
``ring_allgather_matmul``, ``reduce_scatter_matmul``, ``psum_quantized``,
``grad_compress``, ``pipeline_parallel``) go with the LM zoo, ROADMAP
Queue A 11.
"""
from repro_torch.distributed.mesh import (
    BACKENDS,
    DataMesh,
    axis_tuple,
    host_gather,
    init_mesh,
    kv_allreduce,
    run_world,
)

__all__ = [
    "BACKENDS",
    "DataMesh",
    "axis_tuple",
    "host_gather",
    "init_mesh",
    "kv_allreduce",
    "run_world",
]
