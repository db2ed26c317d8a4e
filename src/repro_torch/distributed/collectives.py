"""Hand-written collectives for compute/communication overlap — the port of
``repro.distributed.collectives``.

Each function runs on every rank of the process group of one mesh axis (a
``DeviceMesh`` dimension, ``mesh.get_group(axis)``, or a ``DataMesh``'s
group) and takes the rank's own blocks, as the reference's ``shard_map``
bodies do. Collective: every rank of the axis calls it.

``ring_allgather_matmul``: y = X_full @ W with X sharded over the axis on
its last dim and W on its rows. In place of all-gather(X) then the matmul,
N − 1 ring hops (``batch_isend_irecv``: each rank sends its current X and W
blocks to the next rank and receives the previous rank's) are interleaved
with the N partial products: a hop is posted, the product of the blocks in
hand runs while it is in flight, then the hop is awaited (the "collective
matmul", Wang et al. 2023).

``reduce_scatter_matmul``: y = X @ W with W sharded on its *input* dim:
each rank's partial product, reduce-scattered over the axis (rank i keeps
row block i of the sum).

``psum_quantized``: an all-reduce with an int8 wire format: the scale is
the max all-reduce of max|x| over qmax, the int8 payload is summed in
int32 (no overflow), dequantized once.

gloo moves no CUDA tensor: under gloo a CUDA operand is staged to the host
by an explicit ``.cpu()`` and the result goes back with ``.to(device)``, as
``DataMesh`` does.
"""
from __future__ import annotations

import torch

__all__ = ["ring_allgather_matmul", "reduce_scatter_matmul", "psum_quantized", "axis_group"]


def axis_group(mesh, axis):
    """(process group, size, this rank's index) of ``mesh``'s axis ``axis``:
    a ``DeviceMesh`` dimension by name, or a ``DataMesh`` (whose group is
    its data axes'; its ``check_axis`` holds ``axis`` to them). A world of
    1 has group None."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        if axis not in names:
            raise ValueError(f"axis {axis!r} is not one of the mesh's {names}")
        return mesh.get_group(axis), mesh.size(names.index(axis)), mesh.get_local_rank(axis)
    mesh.check_axis(axis)
    return mesh.group, mesh.world, mesh.rank


def _staged(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    """``t`` all-reduced over ``group`` with ``op`` (a new tensor; through
    the host under gloo)."""
    import torch.distributed as dist

    if _staged(t, group):
        buf = t.cpu()
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(t.device)
    buf = t.clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf


def _ring_hop(blocks: list, group, n: int, idx: int):
    """Post one ring hop of ``blocks`` (each to rank idx + 1, from idx − 1);
    returns (requests, receive buffers, finish) with ``finish()`` giving
    the received blocks on their device."""
    import torch.distributed as dist

    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    staged = [_staged(b, group) for b in blocks]
    send = [b.cpu() if s else b.contiguous() for b, s in zip(blocks, staged)]
    recv = [torch.empty_like(b) for b in send]
    ops = []
    for s, r in zip(send, recv):
        ops.append(dist.P2POp(dist.isend, s, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    reqs = dist.batch_isend_irecv(ops)

    def finish():
        for q in reqs:
            q.wait()
        return [r.to(b.device) if s else r for r, b, s in zip(recv, blocks, staged)]

    return finish


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis: str = "model"):
    """y = allgather(x, axis) @ w, overlapped.

    x: (..., M, K/N), this rank's block of the last dim; w: (K/N, F), this
    rank's row block of the (K, F) weight. Returns (..., M, F), the full
    product, on every rank of the axis: the sum of the N block products, in
    ring order from the rank's own."""
    group, n, idx = axis_group(mesh, axis)
    acc = x @ w  # local block product
    blk, ws = x, w
    for _ in range(1, n):
        finish = _ring_hop([blk, ws], group, n, idx)
        blk, ws = finish()
        acc = acc + blk @ ws
    return acc


def reduce_scatter_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis: str = "model"):
    """y = reduce_scatter(x @ w) over the axis with x's last dim and w's
    rows sharded: rank i returns row block i (M/N, F) of the (M, F) sum."""
    import torch.distributed as dist

    group, n, idx = axis_group(mesh, axis)
    full = x @ w  # (M, F) partial sum on every rank
    if n == 1:
        return full
    if full.shape[0] % n:
        raise ValueError(f"{full.shape[0]} rows do not scatter over {n} ranks")
    rows = full.shape[0] // n
    if dist.get_backend(group) == "gloo":
        # gloo has no reduce-scatter of tensors: the sum, then the rank's rows
        return _all_reduce(full, group, dist.ReduceOp.SUM)[idx * rows:(idx + 1) * rows]
    out = torch.empty((rows,) + tuple(full.shape[1:]), dtype=full.dtype, device=full.device)
    dist.reduce_scatter_tensor(out, full.contiguous(), group=group)
    return out


def psum_quantized(x: torch.Tensor, mesh, axis: str = "data", *, bits: int = 8):
    """All-reduce of ``x`` with an int8 wire format (module doc): the same
    float32 result on every rank of the axis. Per-tensor symmetric
    quantization; pair with error feedback (``grad_compress.py``)."""
    import torch.distributed as dist

    group, n, _ = axis_group(mesh, axis)
    qmax = 2 ** (bits - 1) - 1
    amax = torch.max(torch.abs(x)).float()
    if n > 1:
        amax = _all_reduce(amax, group, dist.ReduceOp.MAX)
    scale = torch.clamp(amax / qmax, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    total = _all_reduce(q, group, dist.ReduceOp.SUM) if n > 1 else q
    return total.to(torch.float32) * scale
