"""Weights and training states carried across from the JAX package: its
parameter pytree, as numpy arrays with layer-stacked leading axes
(``jax.tree.map(np.asarray, params)``), becomes the port's :class:`Model`,
so both compute the same function on the same numbers; a reference
``TrainState`` (step, params, optimizer moments as numpy) becomes a
training model and the port's ``TrainState``, so one more step in each
package computes the same thing."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import EncDecModel, Model, check_supported, hybrid_layout
from repro_torch.train.state import TrainState


def model_from_jax(cfg: ModelConfig, np_params: dict, device=None, *, train: bool = False,
                   remat: str = "none", xent_chunk: int = 512) -> Model | EncDecModel:
    """``np_params`` = {"emb": {...}, "layers": {part: {leaf: (L, ...)}},
    "ln_f": {...}} of the reference's ``build_model(cfg).init``; a hybrid's
    {"emb", "groups": {"b0": {part: {leaf: (G, ...)}}, ...}, "tail": {"b0":
    {part: {leaf}}, ...}, "ln_f"}; an encdec's {"emb", "enc": {part: {leaf:
    (Le, ...)}}, "dec": {part: {leaf: (Ld, ...)}}, "ln_enc", "ln_dec"}.
    ``train``, ``remat``, ``xent_chunk``: as ``build_model``'s."""
    check_supported(cfg)
    dev = resolve_device(device)

    def tensors(tree: dict, index=None) -> dict:
        return {
            k: torch.tensor(np.asarray(v if index is None else v[index], np.float32), device=dev)
            for k, v in tree.items()
        }

    def layer(parts: dict, index=None) -> dict:
        return {part: tensors(leaves, index) for part, leaves in parts.items()}

    if cfg.family == "encdec":
        tree = {"emb": tensors(np_params["emb"]),
                "enc": [layer(np_params["enc"], i) for i in range(cfg.n_enc_layers)],
                "dec": [layer(np_params["dec"], i) for i in range(cfg.n_dec_layers)],
                "ln_enc": tensors(np_params["ln_enc"]), "ln_dec": tensors(np_params["ln_dec"])}
        return EncDecModel(cfg, tree, train=train, remat=remat, xent_chunk=xent_chunk)
    if cfg.family == "hybrid":
        plen, n_groups, n_tail = hybrid_layout(cfg)
        groups, tail = np_params.get("groups", {}), np_params.get("tail", {})
        layers = [layer(groups[f"b{b}"], g) for g in range(n_groups) for b in range(plen)]
        layers += [layer(tail[f"b{b}"]) for b in range(n_tail)]
    else:
        layers = [layer(np_params["layers"], i) for i in range(cfg.n_layers)]
    tree = {"emb": tensors(np_params["emb"]), "layers": layers,
            "ln_f": tensors(np_params["ln_f"])}
    return Model(cfg, tree, train=train, remat=remat, xent_chunk=xent_chunk)


def _leaf_paths(tree, path: tuple = ()) -> list[tuple]:
    """The key paths of a tree of dicts, in flatten order (sorted keys)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], path + (k,))]
    return [path]


def _subtree(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _carry(port, ref, paths: list[tuple]):
    """``ref`` (the reference's optimizer state, numpy leaves) in the
    structure of ``port`` (the port's freshly initialised one): a list with
    an entry a parameter leaf takes the reference's subtree at each
    parameter's path; tuples and dicts map onto themselves."""
    if isinstance(port, tuple):
        return tuple(_carry(p, r, paths) for p, r in zip(port, ref, strict=True))
    if isinstance(port, dict):
        if set(port) != set(ref):
            raise ValueError(f"optimizer state keys differ: {sorted(port)} vs {sorted(ref)}")
        return {k: _carry(port[k], ref[k], paths) for k in port}
    if isinstance(port, list):
        return [_carry(p, _subtree(ref, path), paths) for p, path in zip(port, paths, strict=True)]
    arr = np.asarray(ref)
    if tuple(arr.shape) != tuple(port.shape):
        raise ValueError(f"shape mismatch: {tuple(port.shape)} vs {arr.shape}")
    return torch.tensor(arr, dtype=port.dtype, device=port.device)


def train_state_from_jax(cfg: ModelConfig, np_state, optimizer, device=None, *,
                         remat: str = "none", xent_chunk: int = 512) -> tuple[Model, TrainState]:
    """A reference ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) → (a training model holding its params, the port's
    ``TrainState`` with its step and the optimizer's state carried across).
    ``optimizer`` is the port's counterpart of the one that made the state
    (``chain`` nests as the reference's; its moments are lists in the
    parameters' flatten order)."""
    model = model_from_jax(cfg, np_state.params, device, train=True, remat=remat,
                           xent_chunk=xent_chunk)
    params = model.param_tree()
    paths = _leaf_paths(params)
    opt_state = _carry(optimizer.init([_subtree(params, p) for p in paths]), np_state.opt_state,
                       paths)
    return model, TrainState(int(np_state.step), params, opt_state)
