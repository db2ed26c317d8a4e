"""The data-parallel mesh of the port: a ``torch.distributed`` process group,
one rank per device.

In the JAX package a mesh is a set of devices inside one program
(``shard_map`` bodies, ``psum``). Here each device is driven by its own
process, and ``DataMesh`` is what a rank knows of the others: the world size,
its rank, the process group, its device and the names of its data axes (one
name or a tuple, as ``launch.mesh.data_axes`` gives them). Every rank holds
one row shard, so the shard count is the world size; the data axes are kept
for the reference's ``axis=`` arguments, which ``check_axis`` holds to them
(model-parallel axes belong to the LM zoo, ROADMAP Queue A 11).

A world of 1 needs no initialised process group: every collective is then
the identity and returns its input, with no copy and no count.

**Backends, explicit.** NCCL is for one rank per GPU (``launch.stages.
data_mesh`` picks it under ``torchrun`` on CUDA). gloo is used only where a
caller names it: the CPU tests, ``train_mctm --fake-devices``, and ranks that
share one card. A group that fails to initialise raises. gloo moves no CUDA
tensor, so under gloo a fold's buffer is staged to the host by an explicit
``.cpu()`` and the result goes back with ``.to(device)``
(``census["staged_bytes"]`` counts what crossed).

**The fixed-order fold** is the port's ``psum``. Each accumulation sweep
packs its per-rank partials (the ``TwoPassExact`` (G, Σp, Σppᵀ), the
``OnePassSketched`` SX, an evaluator's totals, a step's loss and gradient)
into one byte buffer and makes ONE ``all_gather`` of it; every rank then
unpacks the partials and sums them in rank order, each in its own dtype. So
every rank holds the same bits whatever the backend and whatever order a
ring all-reduce would have summed in. So a gloo world of 4 and an NCCL world
of 4 should agree bit for bit by construction (not yet run: NCCL has run at
world 1 only, on one card), and the sweeps keep the reference's collective
budget (one collective a sweep, COLL-ONE-PSUM; one gather pair for the hull
extremes, COLL-HULL-GATHER). The price is R× the bytes of an all-reduce:
nothing at D = 14 (44 KB of SX at sketch 784), 134 MB a rank for SX at
D = 2,048 with sketch 16,384. ``census`` counts the collectives and bytes by
kind, so tests and the chip smoke check the budget and print the bytes.

``host_gather`` and ``kv_allreduce`` exchange host arrays (pickled) over a
gloo group of their own, created with ``timeout=`` from the ``ft`` config's
``kv_timeout_ms``: a peer that never arrives surfaces as the
``RuntimeError`` that ``ft.RunSupervisor`` retries, as in the reference.

``init_mesh`` joins a rank to a world through a file store (no port to
collide with under pytest-xdist); ``run_world`` spawns a world of ranks
(start method ``spawn``) running one function and returns each rank's
result, killing every rank it started if one fails or the deadline passes;
``expect_exit=`` lets named ranks die with a named code while the others
run on (the peer-death drill, ``tests/test_torch_drill.py``). ``fake_mesh``
is one rank of an in-process fake world, on which the invariant auditor and
the pod dry run trace sharded programs without peers.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import threading
import time
import traceback
from typing import Callable

import numpy as np
import torch

__all__ = [
    "DataMesh",
    "BACKENDS",
    "axis_tuple",
    "init_mesh",
    "run_world",
    "RankExit",
    "FakeWorldMesh",
    "fake_mesh",
    "host_gather",
    "kv_allreduce",
]

BACKENDS = ("nccl", "gloo")
_ALIGN = 8  # every packed part starts on an 8-byte boundary
_CLOSE_WAIT_S = 10.0  # survivor mode: how long a rank with its result written waits to leave


def axis_tuple(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclasses.dataclass
class DataMesh:
    """One rank's view of a data-parallel world (module doc).

    ``device`` is the rank's (None → CUDA, which must exist; the CPU only
    when asked). ``axes`` names the data axes; every rank is a row shard.
    ``group`` is the process group of the collectives (None at world 1),
    ``kv_group`` the gloo group of ``host_gather`` and ``kv_allreduce``."""

    world: int = 1
    rank: int = 0
    device: torch.device | str | None = None
    backend: str | None = None
    group: object = None
    kv_group: object = None
    axes: tuple = ("data",)
    census: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        from repro_torch.device import resolve_device

        self.device = resolve_device(self.device)
        self.axes = axis_tuple(self.axes)
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.world > 1 and self.group is None:
            raise ValueError("a world of more than one rank needs a process group")

    def check_axis(self, axis) -> None:
        """Refuse an ``axis=`` that is not the mesh's data axes: rows shard
        over every rank, and a subset of the axes would leave ranks idle."""
        if axis_tuple(axis) != self.axes:
            raise ValueError(f"axis {axis!r} is not the mesh's data axes {self.axes}")

    # ------------------------------------------------------------ census

    def _count(self, kind: str, nbytes: int, staged: int = 0) -> None:
        c = self.census.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += int(nbytes)
        if staged:
            self.census["staged_bytes"] = self.census.get("staged_bytes", 0) + int(staged)

    def reset_census(self) -> None:
        self.census.clear()

    def calls(self, kind: str) -> int:
        return self.census.get(kind, {}).get("calls", 0)

    # ------------------------------------------------------- collectives

    def all_gather(self, buf: torch.Tensor, kind: str) -> torch.Tensor:
        """(world, *buf.shape): every rank's ``buf`` in rank order, on
        ``buf``'s device. One collective."""
        if self.world == 1:
            return buf.unsqueeze(0)
        import torch.distributed as dist

        stage = self.backend == "gloo" and buf.device.type == "cuda"
        src = buf.contiguous().cpu() if stage else buf.contiguous()
        out = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(out, src, group=self.group)
        self._count(kind, src.numel() * src.element_size() * self.world,
                    staged=src.numel() * src.element_size() * (self.world + 1) if stage else 0)
        got = torch.stack(out)
        return got.to(buf.device) if stage else got

    def fold(self, parts, kind: str = "fold") -> list:
        """Σ over ranks of each tensor in ``parts``, summed in rank order in
        its own dtype, through one ``all_gather`` of the packed bytes (module
        doc). ``None`` entries pass through. World 1: ``parts`` unchanged."""
        parts = list(parts)
        if self.world == 1:
            return parts
        live = [(i, t) for i, t in enumerate(parts) if t is not None]
        dev = live[0][1].device
        chunks, layout, off = [], [], 0
        for i, t in live:
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
            pad = (-raw.numel()) % _ALIGN
            chunks.append(raw)
            if pad:
                chunks.append(torch.zeros(pad, dtype=torch.uint8, device=raw.device))
            layout.append((i, off, raw.numel(), t.dtype, t.shape))
            off += raw.numel() + pad
        gathered = self.all_gather(torch.cat([c.to(dev) for c in chunks]), kind)
        out = list(parts)
        for i, o, nb, dtype, shape in layout:
            total = None
            for r in range(self.world):
                v = gathered[r, o:o + nb].clone().view(dtype).reshape(shape)
                total = v if total is None else total + v
            out[i] = total
        return out

    def fold_host(self, a) -> np.ndarray:
        """``fold`` of one host array (an evaluator's float64 totals)."""
        a = np.asarray(a)
        if self.world == 1:
            return a
        return self.fold([torch.as_tensor(a, device=self.device)])[0].cpu().numpy()

    def gather_rows(self, local: torch.Tensor, per: int, n: int,
                    kind: str = "row_gather") -> torch.Tensor:
        """The (n, ...) rows of a row-sharded result: rank r holds global rows
        [r·per, r·per + len(local)), padded here to ``per`` rows, gathered in
        rank order and cut at n. One collective."""
        if self.world == 1:
            return local[:n]
        pad = per - int(local.shape[0])
        if pad:
            local = torch.cat([local, local.new_zeros((pad,) + tuple(local.shape[1:]))])
        got = self.all_gather(local, kind)
        return got.reshape((self.world * per,) + tuple(local.shape[1:]))[:n]

    def share(self, obj):
        """Rank 0's ``obj`` on every rank (over the kv group)."""
        if self.world == 1:
            return obj
        return _gather_objects(self, obj, "kv_gather")[0]

    def barrier(self) -> None:
        """Wait for every rank (over the kv group: its deadline is
        ``kv_timeout_ms``)."""
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier(group=self.kv_group)

    def close(self) -> None:
        """Leave the world (destroys the default process group)."""
        if self.group is not None:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self.group = self.kv_group = None


@dataclasses.dataclass
class FakeWorldMesh(DataMesh):
    """Rank 0's view of an in-process fake world (``fake_mesh``):
    ``torch.distributed``'s ``fake`` backend, with no peer behind it, so a
    collective moves nothing and returns its output buffers as they were
    (the census counts it as a real one). ``chips`` counts the hardware the
    world stands for (the dry run's production meshes); ``close`` leaves the
    default group only if this mesh made it."""

    chips: int = 0
    owns_group: bool = False

    def close(self) -> None:
        if self.owns_group:
            super().close()
        self.group = self.kv_group = None


def fake_mesh(world: int, *, device, axes=("data",), chips: int = 0) -> FakeWorldMesh:
    """Rank 0's ``FakeWorldMesh`` of ``world`` ranks. Its fake group is the
    process's default group: made here if none exists; one that exists must
    be a fake world of the same size (it is shared, and left to its maker).
    On a CUDA device the mesh takes the NCCL path (no host staging)."""
    import torch.distributed as dist

    owns = False
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of {dist.get_world_size()} ranks is "
                f"already the default group; a fake world of {world} needs its place")
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        owns = True
    device = torch.device(device)
    return FakeWorldMesh(world=world, rank=0, device=device,
                         backend="nccl" if device.type == "cuda" else "gloo",
                         group=dist.group.WORLD, axes=axes, chips=chips or world,
                         owns_group=owns)


def _kv_timeout() -> datetime.timedelta:
    from repro_torch.ft.config import get_ft_config

    return datetime.timedelta(milliseconds=int(get_ft_config().kv_timeout_ms))


def init_mesh(rank: int, world: int, *, backend: str, device, init_method: str,
              axes=("data",)) -> DataMesh:
    """Join rank ``rank`` of a ``world``-rank mesh on ``backend`` (named: no
    default) through ``init_method`` (``file://…`` or ``env://``). The
    default group is the mesh's; a gloo group with the ``ft`` config's
    ``kv_timeout_ms`` carries ``host_gather``/``kv_allreduce``. Raises if
    the group does not come up."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs a CUDA device per rank")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kwargs)
    group = dist.group.WORLD
    kv = dist.new_group(backend="gloo", timeout=_kv_timeout()) if world > 1 else None
    return DataMesh(world=world, rank=rank, device=device, backend=backend, group=group,
                    kv_group=kv, axes=axes)


# ---------------------------------------------------------------------------
# host exchange over the kv group
# ---------------------------------------------------------------------------


def _gather_objects(mesh: DataMesh, obj, kind: str) -> list:
    import torch.distributed as dist

    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.kv_group)
    mesh._count(kind, sum(len(pickle.dumps(o)) for o in out))
    return out


def host_gather(x, mesh: DataMesh | None = None) -> np.ndarray:
    """Every rank's host rows ``x`` concatenated in rank order (any row
    counts). Collective: every rank calls it in the same order. Without a
    mesh, or at world 1: ``np.asarray(x)``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if mesh is None or mesh.world == 1:
        return x
    return np.concatenate(_gather_objects(mesh, x, "kv_gather"), axis=0)


def kv_allreduce(tree, mesh: DataMesh | None = None, *, timeout_ms: int | None = None):
    """Sum a tree (dict, list or tuple) of host arrays across ranks, in rank
    order. Collective. A peer that does not arrive within ``timeout_ms``
    (default the ``ft`` config's ``kv_timeout_ms``, which the kv group was
    made with) raises ``RuntimeError`` (the supervisor's retryable signal).
    Without a mesh, or at world 1: the tree itself."""
    if mesh is None or mesh.world == 1:
        return tree
    if timeout_ms is not None:  # the call's own deadline: every peer arrives first
        import torch.distributed as dist

        dist.monitored_barrier(group=mesh.kv_group,
                               timeout=datetime.timedelta(milliseconds=int(timeout_ms)))
        mesh._count("kv_barrier", 0)
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves = [np.asarray(tree[k]) for k in keys]
    else:
        leaves = [np.asarray(v) for v in tree]
    got = _gather_objects(mesh, leaves, "kv_allreduce")
    out = [np.array(v, copy=True) for v in got[0]]
    for other in got[1:]:
        for acc, v in zip(out, other):
            acc += v
    if isinstance(tree, dict):
        return dict(zip(keys, out))
    return type(tree)(out) if isinstance(tree, tuple) else out


# ---------------------------------------------------------------------------
# spawned worlds
# ---------------------------------------------------------------------------


def _write_result(out_path, result) -> None:
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".tmp", out_path)


def _rank_main(fn, rank, world, backend, device, init_method, axes, args, out_path, env,
               survivor=False):
    os.environ.update(env)
    torch.set_num_threads(1)
    mesh = None
    try:
        mesh = init_mesh(rank, world, backend=backend, device=device,
                         init_method=init_method, axes=axes)
        result = ("ok", fn(mesh, *args))
    except Exception as exc:  # noqa: BLE001 — reported to the parent, which raises
        result = ("err", f"rank {rank}: {type(exc).__name__}: {exc}\n{traceback.format_exc()}")
    if not survivor:
        # every peer is alive: a close that hangs leaves no result, and the
        # parent's deadline reports it
        if mesh is not None:
            mesh.close()
        _write_result(out_path, result)
        return
    # a peer is to die: the result first, since leaving a world whose peer
    # has died may not return; the rank then gives the close a deadline
    _write_result(out_path, result)
    if mesh is not None:
        closer = threading.Thread(target=mesh.close, daemon=True)
        closer.start()
        closer.join(_CLOSE_WAIT_S)
        if closer.is_alive():  # the dead peer holds the group
            os._exit(0)


@dataclasses.dataclass(frozen=True)
class RankExit:
    """A rank of ``run_world`` that exited with the code ``expect_exit``
    named for it, in that rank's place among the results."""

    rank: int
    code: int


def run_world(fn: Callable, world: int, *, backend: str, devices=None, args: tuple = (),
              axes=("data",), timeout_s: float = 600.0, env: dict | None = None,
              expect_exit: dict | None = None) -> list:
    """Spawn ``world`` ranks, each running ``fn(mesh, *args)`` on its
    ``DataMesh``, and return their results in rank order. Rank r runs on
    ``devices[r]``; by default on ``cuda:r``, one card a rank as under
    ``torchrun``, which must exist (ranks go on the CPU only when
    ``devices`` names it). ``fn`` and ``args`` are pickled (``fn`` by
    import path). A rank that raises, dies or outlives ``timeout_s`` makes
    this raise ``RuntimeError`` once every rank has been stopped. ``env``
    is set in each rank before it starts. Kernels a rank runs must be built
    before the spawn (``kernels._lib.lib()``): ranks load the built library.

    Survivor mode (the peer-death drill): ``expect_exit={rank: code}``
    names ranks that are to die with ``code`` (``os._exit``) and leave no
    result. Such a rank is reported as a ``RankExit`` in its place, and the
    others run on; a rank that dies with another code, or that does not die,
    still makes this raise. In this mode only, the other ranks write their
    results before they leave the world and give leaving ``_CLOSE_WAIT_S``
    (a dead peer may hold the group); outside it a close that hangs is a
    rank that outlives ``timeout_s``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    if devices is None:
        from repro_torch.device import resolve_device

        resolve_device(None)
        devices = [torch.device("cuda", r) for r in range(world)]
    devices = list(devices)
    with tempfile.TemporaryDirectory(prefix="repro_world_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, backend, str(devices[r]), init, axes, args, outs[r], dict(env or {}),
            bool(expect_exit)))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        expect = {int(r): int(c) for r, c in (expect_exit or {}).items()}
        errors, results = [], []
        for r, (p, path) in enumerate(zip(procs, outs)):
            if r in expect:
                if p.exitcode == expect[r] and not os.path.exists(path):
                    results.append(RankExit(r, p.exitcode))
                else:
                    errors.append(f"rank {r}: expected to exit with code {expect[r]}, "
                                  f"exited with {p.exitcode}")
                continue
            if not os.path.exists(path):
                errors.append(f"rank {r}: exited with code {p.exitcode} and no result "
                              f"(deadline {timeout_s:.0f}s)")
                continue
            with open(path, "rb") as f:  # written by our own rank process
                status, value = pickle.load(f)
            if status == "ok":
                results.append(value)
            else:
                errors.append(value)
        if errors:
            raise RuntimeError("mesh world failed:\n" + "\n".join(errors))
        return results
