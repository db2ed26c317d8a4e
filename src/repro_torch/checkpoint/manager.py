"""Fault-tolerant checkpointing: atomic, keep-k, optional async — the port
of ``repro.checkpoint.manager``, in the reference's on-disk format (on a
mesh, rank 0 writes and every rank reads: ``CheckpointManager(mesh=)``).

Layout: ``<dir>/step_<N>/`` — one ``.npy`` per leaf (keypath-encoded
filename) + ``manifest.json`` (step, leaf names, shapes, dtypes). Writes go to
``step_<N>.tmp`` (leaves and manifest fsynced, then the directory entries)
and are atomically renamed, so a crash mid-save never corrupts the latest
restorable step: a torn ``step_N.tmp`` is invisible to ``latest_step()`` /
``restore()`` and is reclaimed by the next save's GC.

A state is a tree of dicts, tuples (a NamedTuple, or any type with
``_fields``, by field name), lists and leaves: tensors (saved as
``.detach().cpu().numpy()``), numpy arrays and scalars. Leaf names join the
keypath as the reference's ``jax.tree_util`` keypaths do (dict keys, field
names, list indices), so a state of the same structure has the same leaf
names in both packages and either restores the other's checkpoint.
``None`` is an empty subtree, as in jax. ``restore(target)`` validates
shapes and puts each leaf back on the target leaf's device and dtype; an
``nn.Parameter`` leaf (a model's weight) is restored in place, so the
model that holds it computes with the restored values.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.ft.config import maybe_inject

__all__ = ["CheckpointManager", "flatten_with_names"]

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _fsync_dir(path: str) -> None:
    """fsync a directory entry so renames/creates inside it are durable
    (best-effort: some filesystems refuse it on directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _children(node) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node in the reference's flatten order,
    or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_names(state) -> list[tuple[str, Any]]:
    """(leaf name, leaf) pairs in flatten order; names as the reference's
    ``_leaf_name`` spells a keypath."""
    out: list[tuple[str, Any]] = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append((_SAFE.sub("_", ".".join(path)) or "leaf", node))
            return
        for k, v in kids:
            walk(v, path + [k])

    walk(state, [])
    return out


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(np.shape(x))


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(target, arr: np.ndarray):
    """``arr`` in the flavour of the target leaf: a tensor on its device and
    dtype, a numpy array of its dtype, or a Python/numpy scalar of its type."""
    if isinstance(target, torch.nn.Parameter):
        with torch.no_grad():
            target.copy_(torch.as_tensor(arr))
        return target
    if isinstance(target, torch.Tensor):
        return torch.as_tensor(arr).to(device=target.device, dtype=target.dtype)
    if isinstance(target, np.ndarray):
        return np.asarray(arr, dtype=target.dtype)
    if isinstance(target, np.generic):
        return target.dtype.type(arr)
    if isinstance(target, (bool, int, float)):
        return type(target)(arr.item())
    return arr


def unflatten_like(template, leaves: list):
    """Rebuild ``template``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        vals = [build(v) for _, v in kids]
        if hasattr(node, "_fields"):
            return type(node)(*vals)
        return type(node)(vals)

    return build(template)


class CheckpointManager:
    """``mesh=`` (a ``repro_torch.distributed.DataMesh``) is the reference's
    multi-process branch for a state every rank holds alike (a fit's
    parameters and moments): rank 0 writes, every rank reads, and every
    rank waits at a barrier after each save, so a rank that restores reads
    the save its peers made. Every rank passes the save's failure-injection
    point, so an injected torn write fails all ranks at the same step."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = False, mesh=None):
        self.directory = str(directory)
        self.keep = keep
        self.async_save = async_save
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self._thread: threading.Thread | None = None
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------ save

    def save(self, step: int, state, *, block: bool = True) -> str:
        """Save a state tree; atomic rename at the end. Returns the final path."""
        self.wait()  # one in-flight async save at a time
        leaves = [(name, _to_host(x)) for name, x in flatten_with_names(state)]
        final = os.path.join(self.directory, f"step_{step:08d}")

        def _write():
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            existing: set[str] = set()
            for name, leaf in leaves:
                base, i = name, 0  # disambiguate collisions deterministically
                while name in existing:
                    i += 1
                    name = f"{base}__{i}"
                existing.add(name)
                with open(os.path.join(tmp, name + ".npy"), "wb") as f:
                    np.save(f, leaf)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["leaves"].append(
                    {"name": name, "shape": list(np.shape(leaf)), "dtype": str(leaf.dtype)}
                )
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            maybe_inject("checkpoint", step)  # torn write: fully built tmp, no rename
            _fsync_dir(tmp)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            _fsync_dir(self.directory)
            self._gc()
            return final

        if self.mesh is not None:
            if self.mesh.rank == 0:
                _write()
            else:
                maybe_inject("checkpoint", step)
            self.mesh.barrier()
            return final
        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
            return final
        return _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
        # torn tmp dirs from a crash mid-save are never restorable, only
        # reclaimable; this save's own tmp is renamed by now
        for d in os.listdir(self.directory):
            if re.fullmatch(r"step_\d+\.tmp", d):
                shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read(self, step: int | None):
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        return [(e["name"], np.load(os.path.join(d, e["name"] + ".npy")))
                for e in manifest["leaves"]]

    def restore(self, target, step: int | None = None):
        """Restore into the structure of ``target`` (shapes validated), each
        leaf in its target leaf's flavour (device, dtype)."""
        arrays = [a for _, a in self._read(step)]
        leaves = [x for _, x in flatten_with_names(target)]
        if len(leaves) != len(arrays):
            raise ValueError(f"checkpoint has {len(arrays)} leaves, target has {len(leaves)}")
        for tgt, arr in zip(leaves, arrays):
            if _shape(tgt) != tuple(arr.shape):
                raise ValueError(f"shape mismatch: {_shape(tgt)} vs {arr.shape}")
        return unflatten_like(target, [_like(t, a) for t, a in zip(leaves, arrays)])

    def restore_flat(self, step: int | None = None) -> dict[str, np.ndarray]:
        """A checkpoint as ``{leaf_name: array}`` without a template, for a
        caller whose state is ragged (the streaming maintainer's buckets);
        only flat dict states round-trip by name."""
        return dict(self._read(step))
