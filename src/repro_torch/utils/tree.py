"""Tree helpers used across the port — the port of ``repro.utils.tree``.

A tree is a dict, list or tuple of tensors (the port's parameter and
optimizer-state trees, the LM's ``param_tree()``); NamedTuples are trees
too, and their fields are walked in order. A logical sharding spec is a
plain tuple of axis names, which is why ``is_spec_leaf`` excludes
NamedTuples: a spec tree can then mirror any parameter tree.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["is_spec_leaf", "tree_leaves", "tree_map", "tree_like", "tree_size", "tree_bytes",
           "tree_allclose", "tree_norm", "tree_cast"]


def is_spec_leaf(x) -> bool:
    """Logical-sharding-spec leaves are plain tuples of axis names; parameter
    containers may themselves be NamedTuples, which are tuples too: they are
    excluded, so spec trees can mirror any parameter tree. Shared by the
    sharding resolver and the optimizers' ``state_specs``. Its entries are
    names or None, so ``chain``'s tuple of state specs is a node."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in the reference's flatten order (sorted dict
    keys; list, tuple and field order). ``None`` is an empty subtree."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (and the matching nodes of
    ``rest``), keeping the structure of ``tree``; leaves are visited in
    flatten order."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_like(tree, leaves: list, is_leaf=None):
    """``tree``'s structure with ``leaves`` (in flatten order) in place of
    its own."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree, is_leaf=is_leaf)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_size(tree) -> int:
    """Total number of elements in a tree."""
    return sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree (shape × itemsize: fake and meta tensors too)."""
    return sum(int(np.prod(tuple(x.shape))) * x.dtype.itemsize for x in tree_leaves(tree))


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(np.allclose(_host(x), _host(y), rtol=rtol, atol=atol) for x, y in zip(la, lb))


def tree_norm(tree) -> torch.Tensor:
    """Global l2 norm of a tree, in float32 on the leaves' device."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def tree_cast(tree, dtype):
    """Floating leaves cast to ``dtype``; the others as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() else x.cpu().numpy()
    return np.asarray(x)
