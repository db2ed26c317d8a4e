"""Declarative checks over one call of a registered program of the port.

The reference lowers each jitted hot path and reads its jaxpr and HLO. The
port has no lowering: its programs are Python driving PyTorch ops and hand-
written kernels, so the audit runs the program once and watches it.

**On the CPU** the program is built and called under ``FakeTensorMode``
with a recording ``TorchDispatchMode`` on top: every op is traced with its
output shapes and dtypes, nothing is computed and nothing is allocated.
Every op's output is held to the materialization bound but for the byte
buffers inside ``DataMesh``'s collectives (world × the state, counted by
the census's bytes); float64 arrays inside a kernel's plain version (which
stands for the kernel's body, bit for bit) are counted apart. A
host read of a fake tensor has no value to return, which is how it is
caught: ``.item()`` (and ``float()``, ``bool()``, ``.tolist()``) raise
``DataDependentOutputException`` at ``aten._local_scalar_dense``, and
``.numpy()`` raises ``RuntimeError``. The recorder catches both, notes the
op and the Python frame, and hands back zeros so the trace can go on; an op
whose output shape depends on the data (``nonzero``, ``bincount``) stops
the trace as a failure. Kernels run their plain versions there, counted
by ``kernels._lib.PLAIN_CALLS``.

**On the card** the same program runs with real tensors: once unaudited
(caches, the kernel library), then audited under
``torch.cuda.set_sync_debug_mode("warn")``, each synchronizing call a
warning counted as a host read, with the kernels' ``LAUNCHES`` deltas and
the device kernels of a ``torch.profiler`` window over one more call.

Sharded programs run as rank 0 of an in-process fake world
(``torch.distributed``'s ``fake`` backend: no peer, no data moved, every
collective counted by ``DataMesh.census`` as a real one would be). The
fake group is the process's default group: created only if none exists
(one that does must be a fake world of the same size) and destroyed
afterwards. On the card the mesh takes the NCCL path (no host staging).

``audit_program`` returns ``{name, device, ok, failures, metrics}``;
``metrics`` is what ``scripts/torch_analysis_gate.py`` diffs against the
committed baseline. A program that raises is a failure, never a pass.
"""
from __future__ import annotations

import contextlib
import os
import sys
import traceback
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.registry import CENSUS_KINDS, ProgramSpec

__all__ = ["audit_program", "fake_world", "trace_program", "OpTrace", "PORTABLE_METRICS"]

_HERE = os.path.abspath(__file__)
_PORT = os.path.dirname(os.path.dirname(_HERE))
_SRC = os.path.dirname(_PORT)
_KERNELS = os.path.join(_PORT, "kernels")
_MESH = os.path.join(_PORT, "distributed", "mesh.py")
_F64 = (torch.float64, torch.complex128)
# the warning torch.cuda.set_sync_debug_mode("warn") gives at each synchronizing call
_SYNC_WARNING = "called a synchronizing CUDA operation"
# the metrics that do not depend on the device the program ran on: the card's
# audit must read the CPU's
PORTABLE_METRICS = ("collectives", "collective_bytes", "host_reads", "kernels", "f64_arrays",
                    "inplace_state")


def _frame() -> str:
    """The innermost frame of the port (this module aside) that reached
    the current op: ``path:line (function)``."""
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PORT) and fn != _HERE:
            return f"{os.path.relpath(fn, _SRC)}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "<outside the port>"


def _in_plain_kernel() -> bool:
    """True inside a kernel's plain version (``kernels/*/ref.py``), which
    stands on the CPU for the kernel's body on the card."""
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_KERNELS) and os.path.basename(fn) == "ref.py":
            return True
        f = f.f_back
    return False


def _in_collective() -> bool:
    """True inside ``DataMesh``'s collectives, whose packed and gathered
    byte buffers (world × the state) the collective census and its bytes
    account for."""
    f = sys._getframe(1)
    while f is not None:
        if os.path.abspath(f.f_code.co_filename) == _MESH:
            return True
        f = f.f_back
    return False


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif hasattr(x, "_fields"):  # a parameter module that names its leaves (MCTMParams)
        for f in x._fields:
            yield from _tensors(getattr(x, f))


def _leaves(tree) -> list:
    """The tensors of a state tree (tuples, NamedTuples, lists, dicts) in
    order."""
    return list(_tensors(tree))


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def _placeholder(dtype: torch.dtype):
    if dtype == torch.bool:
        return False
    if dtype.is_floating_point or dtype.is_complex:
        return 0.0
    return 0


class OpTrace(TorchDispatchMode):
    """Records every op of a call: output shapes and dtypes, bytes read and
    written (views excluded), host reads with their frames. With ``fake``
    it answers ``aten._local_scalar_dense`` with zeros (module doc)."""

    def __init__(self, fake: bool, materialization=None):
        super().__init__()
        self.fake = fake
        self.budget = materialization
        self.reads: list[str] = []
        self.mat_failures: list[str] = []
        self._mat_seen: set = set()
        self.max_elems = 0
        self.bytes = 0
        self.f64_arrays: list[str] = []
        self.f64_scalars = 0
        self.f64_plain = 0

    def read(self, what: str) -> None:
        self.reads.append(f"{what} at {_frame()}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.fake and func is torch.ops.aten._local_scalar_dense.default:
            self.read("item")
            return _placeholder(args[0].dtype)
        try:
            out = func(*args, **kwargs)
        except Exception as exc:
            from torch._subclasses.fake_tensor import DynamicOutputShapeException

            if isinstance(exc, DynamicOutputShapeException):
                raise RuntimeError(f"{func}: an output shape that depends on the data (a host "
                                   f"sync on the card) at {_frame()}") from exc
            raise
        if not func.is_view:
            self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out) -> None:
        outs = list(_tensors(out))
        if not outs:  # metadata queries (prim.device, sizes) move nothing
            return
        self.bytes += sum(t.numel() * t.element_size() for t in _tensors((args, kwargs)))
        self.bytes += sum(t.numel() * t.element_size() for t in outs)
        in_mesh = _in_collective()
        for t in outs:
            shape = tuple(int(d) for d in t.shape)
            size = int(np.prod(shape)) if shape else 1
            if not in_mesh:
                self.max_elems = max(self.max_elems, size)
            b = self.budget
            if b is not None and not in_mesh:
                ratio = size // max(shape) if shape and max(shape) else 1
                if ratio > b.row_elems and size > b.fixed_elems:
                    key = (str(func), shape)
                    if key not in self._mat_seen:
                        self._mat_seen.add(key)
                        self.mat_failures.append(
                            f"materialization: {func} produces {t.dtype} {list(shape)} ({size} "
                            f"elems, {ratio}/row) at {_frame()} — wider than row budget "
                            f"{b.row_elems} and larger than chunk budget {b.fixed_elems}; an "
                            f"n-scaled basis block is being materialized")
            if t.dtype in _F64:
                if t.dim() == 0:
                    self.f64_scalars += 1
                elif _in_plain_kernel():
                    self.f64_plain += 1
                else:
                    self.f64_arrays.append(f"{func} → {t.dtype} {list(shape)} at {_frame()}")


@contextlib.contextmanager
def _fake_host_reads(trace: OpTrace):
    """``.numpy()`` and ``.tolist()`` of a fake tensor: one read each,
    answered with zeros (a fake tensor holds no values)."""
    saved = {k: torch.Tensor.__dict__.get(k) for k in ("numpy", "tolist")}
    base_numpy, base_tolist = torch.Tensor.numpy, torch.Tensor.tolist

    def numpy(self, *a, **k):
        if _is_fake(self):
            trace.read("numpy")
            return np.zeros(tuple(self.shape), dtype=_np_dtype(self.dtype))
        return base_numpy(self, *a, **k)

    def tolist(self, *a, **k):
        if _is_fake(self):
            trace.read("tolist")
            return np.zeros(tuple(self.shape), dtype=_np_dtype(self.dtype)).tolist()
        return base_tolist(self, *a, **k)

    torch.Tensor.numpy, torch.Tensor.tolist = numpy, tolist
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                delattr(torch.Tensor, k)
            else:
                setattr(torch.Tensor, k, v)


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
              torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
              torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_,
              torch.complex64: np.complex64, torch.complex128: np.complex128}


def _np_dtype(dtype: torch.dtype):
    return _NP_DTYPES.get(dtype, np.float32)


@contextlib.contextmanager
def fake_world(world: int, device, axes=("data",)):
    """Rank 0's ``DataMesh`` on an in-process fake world of ``world`` ranks
    (``distributed.fake_mesh``; module doc); None at a world of 1."""
    if world <= 1:
        yield None
        return
    from repro_torch.distributed.mesh import fake_mesh

    mesh = fake_mesh(world, device=device, axes=axes)
    try:
        yield mesh
    finally:
        mesh.close()


def _census(mesh) -> tuple[dict, int]:
    if mesh is None:
        return dict.fromkeys(CENSUS_KINDS, 0), 0
    calls = {k: mesh.calls(k) for k in CENSUS_KINDS}
    extra = {k: v["calls"] for k, v in mesh.census.items()
             if isinstance(v, dict) and k not in CENSUS_KINDS}
    calls.update(extra)
    nbytes = sum(v["bytes"] for v in mesh.census.values() if isinstance(v, dict))
    return calls, int(nbytes)


def _kernel_modules() -> dict:
    from repro_torch.kernels.bernstein import ops as bern
    from repro_torch.kernels.extremes import ops as ext
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gram import ops as gram
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.kernels.sweep import ops as sweep

    return {"bernstein": bern, "gram": gram, "extremes": ext, "sweep": sweep,
            "flash_attention": fa, "ssd": ssd}


def _kernel_counts(card: bool) -> dict:
    if card:
        return {k: m.LAUNCHES for k, m in _kernel_modules().items()}
    from repro_torch.kernels import _lib

    return dict(_lib.PLAIN_CALLS)


def _path_counts() -> dict:
    out = {}
    for k, m in _kernel_modules().items():
        for path, v in getattr(m, "PATH_LAUNCHES", {}).items():
            out[f"{k}/{path}"] = v
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def _storage_ids(leaves) -> list[int]:
    return [t.untyped_storage()._cdata for t in leaves]


def trace_program(fn, args, *, card: bool, materialization=None, mesh=None):
    """One audited call of ``fn(*args)``: returns ``(out, trace, host_reads,
    kernels, census)``. On the CPU the arguments must be fake tensors."""
    trace = OpTrace(fake=not card, materialization=materialization)
    if mesh is not None:
        mesh.reset_census()
    k0 = _kernel_counts(card)
    with contextlib.ExitStack() as stack:
        if card:
            caught = stack.enter_context(warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, "default")
        else:
            stack.enter_context(_fake_host_reads(trace))
        with trace:
            out = fn(*args)
    if card:
        torch.cuda.synchronize()
        syncs = [f"{w.message} at {os.path.relpath(w.filename, _SRC)}:{w.lineno}"
                 for w in caught if _SYNC_WARNING in str(w.message)]
        host_reads = syncs
    else:
        host_reads = list(trace.reads)
    kernels = _delta(_kernel_counts(card), k0)
    census = _census(mesh)
    return out, trace, host_reads, kernels, census


_PROFILE_TRIES = 3


def _device_kernels(fn, args) -> int | None:
    """Device kernels of one more call, from a ``torch.profiler`` window,
    taken again while it holds none (late in a long process the profiler
    has been seen to drop a window's kernel records); None when every try
    came back empty."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(_PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            return n
    return None


def audit_program(spec: ProgramSpec, device=None) -> dict:
    """Run every check against one registered program on ``device`` (None:
    the card, which must exist; the CPU only when asked). Returns
    ``{"name", "device", "ok", "failures": [...], "metrics": {...}}``."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    card = dev.type == "cuda"
    report: dict = {"name": spec.name, "device": dev.type, "failures": [], "metrics": {}}
    fail = report["failures"]
    with fake_world(spec.needs_world, dev) as mesh:
        try:
            if card:
                fn, args = spec.build(dev, mesh)
                fn(*args)  # warm-up: caches and the kernel library load, unaudited
                torch.cuda.synchronize()
                before = _storage_ids(_leaves(args[0])) if spec.inplace_state is not None else []
                p0 = _path_counts()
                out, trace, reads, kernels, (census, cbytes) = trace_program(
                    fn, args, card=True, materialization=spec.materialization, mesh=mesh)
                report["metrics"]["kernel_paths"] = _delta(_path_counts(), p0)
            else:
                from torch._subclasses.fake_tensor import FakeTensorMode

                with FakeTensorMode(allow_non_fake_inputs=True):
                    fn, args = spec.build(dev, mesh)
                    before = (_storage_ids(_leaves(args[0]))
                              if spec.inplace_state is not None else [])
                    out, trace, reads, kernels, (census, cbytes) = trace_program(
                        fn, args, card=False, materialization=spec.materialization, mesh=mesh)
        except Exception as exc:  # noqa: BLE001 — reported as the program's failure
            fail.append(f"the program raised {type(exc).__name__}: {exc}\n"
                        + "".join(traceback.format_exception(exc)[-3:]))
            report["ok"] = False
            return report
        if card:
            report["metrics"]["device_kernels"] = _device_kernels(fn, args)
    m = report["metrics"]
    m.update({
        "collectives": census,
        "collective_bytes": cbytes,
        "max_intermediate_elems": trace.max_elems,
        "f64_arrays": len(trace.f64_arrays),
        "f64_scalars": trace.f64_scalars,
        "f64_in_plain_kernels": trace.f64_plain,
        "host_reads": len(reads),
        "kernels": kernels,
    })
    # collective census
    budget = spec.collectives.as_dict()
    for kind in sorted(set(budget) | set(census)):
        got, want = census.get(kind, 0), budget.get(kind, 0)
        if spec.collectives.exact and got != want:
            fail.append(f"collective census: {got} × {kind}, budget declares exactly {want} — "
                        f"a refactor changed the program's reduction structure")
        elif not spec.collectives.exact and got > want:
            fail.append(f"collective census: {got} × {kind} exceeds ceiling {want}")
    # materialization
    fail.extend(trace.mat_failures)
    # dtype
    if not spec.allow_f64 and trace.f64_arrays:
        fail.append(f"dtype audit: {len(trace.f64_arrays)} float64 tensor(s) of rank ≥ 1 — an "
                    f"np.float64 constant or a .double() promotes a data array: "
                    + "; ".join(trace.f64_arrays[:3]))
    # host reads
    if len(reads) != spec.host_reads:
        fail.append(f"host audit: {len(reads)} host read(s), budget declares exactly "
                    f"{spec.host_reads} — every undeclared read serializes the device stream: "
                    + "; ".join(reads[:4]))
    # kernel launches
    want_k = dict(spec.kernels)
    for k in sorted(set(want_k) | set(kernels)):
        if kernels.get(k, 0) != want_k.get(k, 0):
            fail.append(f"kernel census: {kernels.get(k, 0)} × {k}, budget declares exactly "
                        f"{want_k.get(k, 0)}")
    # state reuse
    if spec.inplace_state is not None:
        after = _storage_ids(_leaves(out[0]))
        reused = sum(1 for a, b in zip(before, after) if a == b)
        m["inplace_state"] = reused
        if reused != spec.inplace_state:
            fail.append(f"state audit: the call reuses the storage of {reused} state leaf(s), "
                        f"declared {spec.inplace_state} — an in-place update became a copy "
                        f"(or a copy became in place)")
    report["ok"] = not fail
    return report
