"""Weights carried across from the JAX package: its parameter pytree, as
numpy arrays with layer-stacked leading axes (``jax.tree.map(np.asarray,
params)``), becomes the port's :class:`Model`, so both compute the same
function on the same numbers."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model, check_supported


def model_from_jax(cfg: ModelConfig, np_params: dict, device=None) -> Model:
    """``np_params`` = {"emb": {...}, "layers": {part: {leaf: (L, ...)}},
    "ln_f": {...}} of the reference's ``build_model(cfg).init``."""
    check_supported(cfg)
    dev = resolve_device(device)

    def tensors(tree: dict, index=None) -> dict:
        return {
            k: torch.tensor(np.asarray(v if index is None else v[index], np.float32), device=dev)
            for k, v in tree.items()
        }

    stacked = np_params["layers"]
    tree = {
        "emb": tensors(np_params["emb"]),
        "layers": [{part: tensors(leaves, i) for part, leaves in stacked.items()}
                   for i in range(cfg.n_layers)],
        "ln_f": tensors(np_params["ln_f"]),
    }
    return Model(cfg, tree)
