"""Logical-axis sharding rules → concrete specs and DTensor placements — the
port of ``repro.distributed.sharding``.

Params and caches carry *logical* axis names ('embed', 'heads', 'kv', 'mlp',
'vocab', 'expert', 'lru', 'batch', 'layer', None). A :class:`ShardingRules`
maps logical names to mesh axes; :func:`resolve_spec` drops any assignment
whose dimension is not divisible by the mesh axis size (e.g. MQA's kv=1 head
can't shard over model=16 → replicated), so every arch gets a *valid* spec on
every mesh without per-arch special-casing.

Default strategy (single pod, mesh ('data','model')):
  batch → 'data' | heads/kv/mlp/vocab/expert/lru → 'model' | embed → 'data'
  (FSDP: parameters ZeRO-3-sharded over the data axis)
Multi-pod mesh ('pod','data','model'): batch → ('pod','data'); parameters
stay sharded within a pod and replicated across pods (pure DP on 'pod').

**Meshes.** A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
dimension names are the reference's axes, or, where only specs are wanted
(no process group), any object with ``axis_names`` and a ``shape`` mapping
of name → size (the reference's own ``Mesh``, a test's stand-in).
:func:`resolve_spec` returns a :class:`PartitionSpec`, a tuple of the
reference's per-dim entries (``None``, an axis name, or a tuple of names),
which compares equal to the reference's ``PartitionSpec``.
:func:`to_placements` turns it into one DTensor ``Placement`` per mesh
dimension: a tensor dim sharded over ``("pod", "data")`` is ``Shard(d)`` on
both mesh dims. DTensor splits a dim over its mesh dims in mesh order, the
first the major one, so the block that rank (p, d, m) holds is block
p·|data| + d, as on the reference's device (p, d, m): pod-major.

**Activation constraints.** ``constrain(x, *names)`` is the reference's
``with_sharding_constraint`` by logical names: the identity unless a
launcher calls ``set_activation_axes``; then a DTensor activation is
redistributed to the named placements (a plain tensor passes unchanged).

**Redistribution points.** Where DTensor has no sharding rule for an op of
the model, or one that some of its versions refuse, or one that costs
communication only and so repeats work on every model rank, the model
moves the operand explicitly, at a named point. The points act only
inside ``dtensor_run()`` (``train.shard_train_step``'s step, the dry run's
traces); elsewhere each hands its operand back after one flag read:
"embed_table" (``embed_lookup``), "fsdp_gather" (``fsdp_gather``: each
layer's weights, and the CE's table, gathered over the rows' mesh dims),
"residual" (``reduce_partial``), "head_split" (``split_last``,
``grad_splittable``, ``heads_whole``: head counts the model axes do not
divide), "gqa_heads" and "attention_blocks" (``attention_blocks``: per
(rows, heads) block work), "ssd_blocks" (``local_blocks``), "xent_gold"
(``take_last``), "token_rows" (``split_first``) and "microbatch_split"
(``split_microbatches``, the train step's). ``REDISTRIBUTIONS`` counts each
point's calls and the bytes a rank gains there, so the dry run's records
show them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import is_spec_leaf as _is_spec
from repro_torch.utils.tree import tree_map

PyTree = Any

__all__ = [
    "ShardingRules",
    "PartitionSpec",
    "NamedSharding",
    "default_rules",
    "resolve_spec",
    "resolve_tree",
    "batch_specs",
    "replicated",
    "to_placements",
    "shard_shape",
    "mesh_axes",
    "set_activation_axes",
    "activation_axes_enabled",
    "act_spec",
    "constrain",
    "is_dtensor",
    "dtensor_run",
    "replicate_for",
    "split_microbatches",
    "embed_lookup",
    "local_blocks",
    "attention_blocks",
    "WHOLE",
    "reduce_partial",
    "fsdp_gather",
    "heads_whole",
    "grad_splittable",
    "split_last",
    "split_first",
    "take_last",
    "REDISTRIBUTIONS",
    "reset_redistributions",
]


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor: ``None``, an axis name, or a tuple of
    names (a tuple, so it compares equal to the reference's)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a mesh-like object with
    ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict

    def get(self, name):
        return self.rules.get(name)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec (the reference's ``NamedSharding``);
    ``placements`` are its DTensor placements (a ``DeviceMesh`` only)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def default_rules(mesh, *, fsdp: bool = True) -> ShardingRules:
    multi_pod = "pod" in mesh_axes(mesh)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(
        {
            "batch": batch_axes,
            "embed": ("data",) if fsdp else None,
            "heads": ("model",),
            "kv": ("model",),
            "mlp": ("model",),
            "vocab": ("model",),
            "expert": ("model",),
            "lru": ("model",),
            "seq_kv": ("model",),  # only emitted by decode_seq_shard caches
            "state": None,
            "layer": None,
            None: None,
        }
    )


def _axis_size(axes_of: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([axes_of[a] for a in axes]))


def resolve_spec(logical: tuple, shape: tuple, mesh, rules: ShardingRules) -> PartitionSpec:
    """Logical names → PartitionSpec, dropping non-divisible assignments."""
    axes_of = mesh_axes(mesh)
    out = []
    used: set[str] = set()
    for dim, name in zip(tuple(shape), logical):
        axes = rules.get(name)
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a in axes_of and a not in used)
        if not axes or int(dim) % _axis_size(axes_of, axes) != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return PartitionSpec(*out)


def resolve_tree(specs: PyTree, shapes: PyTree, mesh, rules: ShardingRules) -> PyTree:
    """Map (logical-spec tree, tree of tensors or anything with ``shape``)
    → tree of :class:`NamedSharding`, the structure of ``specs``."""

    def one(spec, arr):
        return NamedSharding(mesh, resolve_spec(tuple(spec), tuple(arr.shape), mesh, rules))

    return tree_map(one, specs, shapes, is_leaf=_is_spec)


def batch_specs(batch_shapes: dict, mesh, rules: ShardingRules) -> dict:
    """Input batch shardings: leading dim = batch, rest replicated."""
    out = {}
    for k, v in batch_shapes.items():
        nd = len(v.shape)
        logical = ("batch",) + (None,) * (nd - 1) if nd else ()
        out[k] = NamedSharding(mesh, resolve_spec(logical, v.shape, mesh, rules))
    return out


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_shape(spec, shape: tuple, mesh) -> tuple:
    """One rank's block shape of a tensor of ``shape`` under ``spec`` (the
    reference's ``NamedSharding.shard_shape``: each dim divided by the
    sizes of its axes)."""
    axes_of = mesh_axes(mesh)
    out = list(int(d) for d in shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            out[d] //= _axis_size(axes_of, entry)
    return tuple(out)


def to_placements(spec, mesh) -> tuple:
    """One DTensor placement per dimension of the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on every mesh dim named in the spec's entry for tensor dim
    d, ``Replicate()`` on the others and on a mesh dim of one rank (the
    same single block: DTensor refuses some views of a dim "sharded" over
    one rank). An entry's axes must follow the mesh's order (pod-major,
    module doc)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"axes {axes} of dim {d} are not in the mesh's order {names}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# Activation-sharding context: lets model code hint the layout with logical
# names without holding a mesh reference. Disabled (identity) unless a
# launcher calls ``set_activation_axes`` — tests and host-scale runs are
# unaffected.
# ---------------------------------------------------------------------------

_ACT: dict = {"enabled": False, "batch": ("data",), "model": ("model",)}


def set_activation_axes(*, batch=("data",), model=("model",), enabled=True):
    _ACT.update(batch=tuple(batch), model=tuple(model), enabled=enabled)


def activation_axes_enabled() -> bool:
    return _ACT["enabled"]


def act_spec(*names) -> PartitionSpec:
    """names ∈ {'batch', 'model', None} → PartitionSpec under current axes."""
    out = []
    for n in names:
        if n is None:
            out.append(None)
        else:
            axes = _ACT[n]
            out.append(axes if len(axes) > 1 else axes[0])
    return PartitionSpec(*out)


def constrain(x, *names):
    """The reference's ``with_sharding_constraint`` by logical names: the
    identity when disabled or on a plain tensor; a DTensor is redistributed
    to the named placements (axes its mesh lacks are left out)."""
    if not _ACT["enabled"] or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    have = set(mesh.mesh_dim_names)
    spec = []
    for entry in act_spec(*names):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        axes = tuple(a for a in axes if a in have)
        spec.append(None if not axes else (axes if len(axes) > 1 else axes[0]))
    return x.redistribute(mesh, to_placements(spec, mesh))


# ---------------------------------------------------------------------------
# explicit redistribution points
#
# The model calls the functions below at named points. They act only inside
# ``dtensor_run()``, which ``shard_train_step``'s step and the dry run's
# traces enter: outside it each hands its operand back after one read of a
# module flag, so an unsharded run (serving, the plain train step) does none
# of their work and never loads DTensor's module.
# ---------------------------------------------------------------------------

_ON = False
_DTENSOR = None
REDISTRIBUTIONS: dict = {}


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (DTensor's class is looked up once)."""
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


@contextlib.contextmanager
def dtensor_run():
    """The context in which the model's redistribution points act: a run
    of the model on DTensors (``train.shard_train_step``'s step, the dry
    run's traces)."""
    global _ON
    is_dtensor(None)  # DTensor's module, loaded once before a point acts
    prev, _ON = _ON, True
    try:
        yield
    finally:
        _ON = prev


def reset_redistributions() -> None:
    REDISTRIBUTIONS.clear()


def _count(point: str, nbytes: int) -> None:
    rec = REDISTRIBUTIONS.setdefault(point, {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += int(nbytes)


def _moved(point: str, x, want):
    """DTensor ``x`` redistributed to the placements ``want`` (itself when
    it has them), counted at ``point`` with the bytes the rank gains."""
    want = tuple(want)
    if tuple(x.placements) == want:
        return x
    before = x.to_local().numel()
    y = x.redistribute(x.device_mesh, want)
    _count(point, max(y.to_local().numel() - before, 0) * x.element_size())
    return y


def replicate_for(point: str, x, *dims: int):
    """``x`` with its tensor dims ``dims`` (all when none is given) no
    longer sharded: the operand an op without a DTensor sharding rule needs,
    at the named ``point``. A plain tensor, or a DTensor already so, passes
    unchanged; otherwise the call and the bytes the rank receives are
    counted in ``REDISTRIBUTIONS[point]``."""
    if not (_ON and is_dtensor(x)):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = set(d % x.ndim for d in dims) if dims else set(range(x.ndim))
    return _moved(point, x, (Replicate() if isinstance(p, Shard) and p.dim in want else p
                             for p in x.placements))


def split_microbatches(point: str, x, microbatches: int):
    """A batch ``x`` (b, ...) as (microbatches, b/microbatches, ...) of
    consecutive rows, as the unsharded split is; on a DTensor split on its
    rows, at the named ``point``: microbatch i's rows lie on a few ranks,
    so the rows are gathered, reshaped, and each rank keeps its rows of
    every microbatch (whole where they do not divide over the batch's mesh
    dims: the ranks then repeat its work)."""
    b = x.shape[0]
    if not (_ON and is_dtensor(x)):
        return x.reshape(microbatches, b // microbatches, *x.shape[1:])
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    placements, ways = [], 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == 0 and (b // microbatches) % (ways * mesh.size(i)) == 0:
            ways *= mesh.size(i)
            placements.append(Shard(1))
        else:
            placements.append(Replicate() if isinstance(p, Shard) and p.dim == 0 else p)
    full = replicate_for(point, x, 0)
    y = full.reshape(microbatches, b // microbatches, *x.shape[1:])
    return y.redistribute(mesh, placements)


def _shard_count(x, dim: int) -> int:
    """How many blocks the DTensor ``x``'s dim ``dim`` is split into."""
    from torch.distributed.tensor import Shard

    dim %= x.ndim
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= x.device_mesh.size(i)
    return n


def _model_ways(x) -> int:
    """How many ways the model axes (``act_spec``'s "model") split the
    mesh the DTensor ``x`` lies on."""
    mesh = x.device_mesh
    n = 1
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in _ACT["model"]:
            n *= mesh.size(i)
    return n


def heads_whole(point: str, x, heads: int):
    """``x`` whole over the model axes (their Partial sums reduced, their
    shards gathered) where ``heads`` do not split evenly over them, at the
    named ``point``: DTensor would otherwise split the head dim unevenly,
    and its views of such a split fail."""
    if not (_ON and is_dtensor(x)):
        return x
    ways = _model_ways(x)
    if ways == 1 or heads % ways == 0:
        return x
    from torch.distributed.tensor import Replicate

    return _moved(point, x, (Replicate() if name in _ACT["model"] else p
                             for name, p in zip(x.device_mesh.mesh_dim_names, x.placements)))


def take_last(point: str, x, index):
    """``torch.gather(x, -1, index)[..., 0]``: on a DTensor, at the named
    ``point``, as Σ x·one_hot(index) over the last dim, which is exact (one
    nonzero term) and which DTensor shards as it shards ``x`` (its gather
    from a sharded operand builds a masked partial that fails to reduce)."""
    if not (_ON and is_dtensor(x)):
        return torch.gather(x, -1, index)[..., 0]
    _count(point, 0)
    hot = torch.nn.functional.one_hot(index[..., 0], x.shape[-1]).to(x.dtype)
    return (x * hot).sum(-1)


def _repeat_heads(point: str, x, repeats: int, like):
    """The DTensor ``x`` (B, T, KV, hd) with each head repeated ``repeats``
    times on dim 2 (GQA's K/V as one head per query head), at the named
    ``point``, then split over dim 2 as ``like`` (the queries) is, so the
    backward hands the repeat a gradient whole on its head dim. Counted
    with the bytes the repeat makes beyond ``x``'s, before the split."""
    from torch.distributed.tensor import Shard

    before = x.to_local().numel()
    y = x.repeat_interleave(repeats, dim=2)
    made = y.to_local().numel() - before
    heads = [Shard(2) if isinstance(q, Shard) and q.dim == 2 else p
             for p, q in zip(y.placements, like.placements)]
    _count(point, made * x.element_size())
    return y.redistribute(y.device_mesh, heads)


def split_first(point: str, x, sizes: tuple):
    """``x`` with its first dim unflattened into ``sizes`` (gathered first
    at the named ``point`` where it is split over more blocks than
    ``sizes[0]`` divides into)."""
    if _ON and is_dtensor(x):
        n = _shard_count(x, 0)
        if n > 1 and sizes[0] % n:
            x = replicate_for(point, x, 0)
    return x.reshape(*sizes, *x.shape[1:])


def split_last(point: str, x, sizes: tuple):
    """``x`` with its last dim unflattened into ``sizes``: where that dim is
    split over more blocks than ``sizes[0]`` divides into (DTensor cannot
    unflatten it), it is gathered first at the named ``point``."""
    if _ON and is_dtensor(x):
        n = _shard_count(x, -1)
        if n > 1 and sizes[0] % n:
            x = replicate_for(point, x, -1)
    return x.reshape(*x.shape[:-1], *sizes)


def grad_splittable(point: str, x, dim: int, lead: int):
    """``x`` itself; on a DTensor, its gradient leaves whole on ``dim``
    where that dim is split over more blocks than ``lead`` divides into, at
    the named ``point``: the gradient of a weight flattened for a matmul
    ((d, KV, hd) → (d, KV·hd)) flows back through the unflatten, which
    DTensor cannot do on such a split."""
    if not (_ON and is_dtensor(x)):
        return x
    return _GradSplittable.apply(x, point, dim, lead)


class _GradSplittable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, point, dim, lead):
        ctx.point, ctx.dim, ctx.lead = point, dim, lead
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = _shard_count(g, ctx.dim)
        if n > 1 and ctx.lead % n:
            g = replicate_for(ctx.point, g, ctx.dim)
        return g, None, None, None


def fsdp_gather(point: str, tree, rows):
    """A layer's parameters (a dict of dicts of tensors) with every DTensor
    leaf gathered over the mesh dims that split the activations ``rows``
    (B, ...) on their rows, at the named ``point`` (ZeRO-3: the weights
    FSDP keeps split over "data" are whole for the layer's use, and their
    gradients reduce-scatter back). Without it DTensor's propagation, which
    costs communication and not compute, may gather a weight over the model
    axis too and repeat the layer's work on every model rank. Where the
    rows are whole on a mesh dim (a microbatch of fewer rows than the data
    axis), the weights stay split there and their products reduce."""
    if not (_ON and is_dtensor(rows)):
        return tree
    from torch.distributed.tensor import Replicate, Shard

    split = {i for i, p in enumerate(rows.placements) if isinstance(p, Shard) and p.dim == 0}

    def one(x):
        if not is_dtensor(x):
            return x
        return _moved(point, x, (Replicate() if isinstance(p, Shard) and i in split else p
                                 for i, p in enumerate(x.placements)))

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else one(v)) for k, v in node.items()}

    return walk(tree)


def reduce_partial(point: str, x):
    """``x`` with its pending sums (DTensor ``Partial`` placements, a
    row-parallel product's) reduced, at the named ``point``: a block's
    output before it joins the residual stream (Megatron's all-reduce; its
    backward hands the gradient on whole, as Megatron's does, where
    DTensor's own would leave it pending). Left pending, the sum flows
    into the next norm and matmul, and DTensor gathers that matmul's weight
    over the model axis and repeats its work on every model rank. Counted
    with the reduced tensor's local bytes."""
    if not (_ON and is_dtensor(x)):
        return x
    from torch.distributed.tensor import Partial

    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    _count(point, x.to_local().numel() * x.element_size())
    return _ReduceSums.apply(x)


def _settled(x):
    from torch.distributed.tensor import Partial, Replicate

    want = tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


class _ReduceSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _settled(x)

    @staticmethod
    def backward(ctx, g):
        return _settled(g)


WHOLE = "whole"  # local_blocks: an argument no rank splits


def local_blocks(point: str, fn, q, args: tuple, head_dims: tuple, out_head_dim: int = 2):
    """``fn(q, *args)`` run on each rank's own block, at the named ``point``:
    work that is independent across batch rows and heads (attention's
    core, a per-head scan). ``q`` (batch first, heads at ``head_dims[0]``)
    sets the blocks: each mesh dim splits the rows where ``q`` is split on
    them, the heads where ``q`` is split on its heads, and nothing else.
    Each tensor of ``args`` takes the same blocks on its own head dim
    (``head_dims[i + 1]``; None: no head dim, split on rows only;
    ``WHOLE``: not split, as an (S, T) mask); a non-tensor passes as it
    is. DTensor would otherwise decompose the work into views that flatten
    sharded dims, which some of its versions refuse. The output is split
    as ``q`` is, its heads at ``out_head_dim`` (a tuple of them for a tuple
    of outputs). A plain ``q`` runs ``fn`` as it is."""
    if not (_ON and is_dtensor(q)):
        return fn(q, *args)
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    mesh, qh = q.device_mesh, head_dims[0]

    def placements(head_dim):
        if head_dim == WHOLE:
            return tuple(Replicate() for _ in q.placements)
        out = []
        for p in q.placements:
            if isinstance(p, Shard) and p.dim == 0:
                out.append(Shard(0))
            elif isinstance(p, Shard) and p.dim == qh and head_dim is not None:
                out.append(Shard(head_dim))
            else:
                out.append(Replicate())
        return tuple(out)

    def place(x, head_dim):
        if not isinstance(x, torch.Tensor):
            return x, None
        want = placements(head_dim)
        if not is_dtensor(x):
            return distribute_tensor(x, mesh, [Replicate()] * mesh.ndim).redistribute(
                mesh, want), want
        return _moved(point, x, want), want

    q, q_pl = place(q, qh)
    placed = [place(a, h) for a, h in zip(args, head_dims[1:])]
    # local_map reads a list as one output's placements, a tuple as outputs
    out_pl = (tuple(list(placements(h)) for h in out_head_dim) if isinstance(out_head_dim, tuple)
              else list(placements(out_head_dim)))
    in_pl = tuple(None if p is None else list(p) for p in (q_pl,) + tuple(p for _, p in placed))
    # an argument whole on a mesh dim that splits the work (no head dim
    # while the heads are split; WHOLE) gets a rank's share of its gradient
    # there: a partial sum
    split = placements(0)
    grad_pl = tuple(None if p is None else [Partial() if isinstance(w, Shard) and not
                                            isinstance(a, Shard) else a
                                            for a, w in zip(p, split)] for p in in_pl)
    run = local_map(fn, out_placements=out_pl, in_placements=in_pl, in_grad_placements=grad_pl,
                    device_mesh=mesh)
    return run(q, *(a for a, _ in placed))


def attention_blocks(fn, q, k, v, *rest, rest_dims: tuple = ()):
    """``fn(q, k, v, *rest)``, attention's core on q (B, S, H, d) and k, v
    (B, T, KV, d). On DTensors: where the model axes split q's heads more
    ways than there are KV heads, k and v first take one head per query
    head (point "gqa_heads": DTensor cannot split a sharded head dim into
    (KV, H/KV)); then the core runs on each rank's (rows, heads) block
    (point "attention_blocks", ``local_blocks``; ``rest_dims`` are the head
    dims of ``rest``, as there)."""
    if not (_ON and is_dtensor(q)):
        return fn(q, k, v, *rest)
    H, KV = q.shape[2], k.shape[2]
    ways = _model_ways(q)
    if KV % ways and not H % ways:
        k, v = (_repeat_heads("gqa_heads", t, H // KV, q) for t in (k, v))
    return local_blocks("attention_blocks", fn, q, (k, v) + rest, (2, 2, 2) + tuple(rest_dims))


def embed_lookup(point: str, table, tokens):
    """``table[tokens]``; on a DTensor table, at the named ``point``, the
    table gathered whole (the FSDP gather of the embedding) and the lookup
    run on each rank's own token rows (``local_map``), the table's gradient
    a partial sum over the mesh dims that split the rows. DTensor's own
    rules for the lookup fail in its backward on the torch versions at
    hand (2.11: an unnormalized shard dim; 2.13: a masked partial that
    cannot meet a plain one)."""
    if not (_ON and is_dtensor(table)):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = distribute_tensor(tokens, mesh, [Replicate()] * mesh.ndim)
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in tokens.placements]
    tokens = tokens.redistribute(mesh, rows)
    whole = [Replicate()] * mesh.ndim
    full = _moved(point, table, whole)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    run = local_map(lambda t, ids: t[ids], out_placements=list(rows),
                    in_placements=(whole, list(rows)), in_grad_placements=(grad, list(rows)),
                    device_mesh=mesh)
    return run(full, tokens)
