"""Decoder-LM assembly (``repro/models/transformer.py``) for the families the
port serves: dense (GQA) and SSM (mamba2).

``build_model(cfg)`` returns a :class:`Model`, an ``nn.Module`` that holds
its weights and keeps the reference's entry points:

  * ``init_cache(batch, max_len) -> cache``
  * ``prefill(batch, cache) -> (logits_last, cache)``
  * ``decode_step(tokens, cache) -> (logits, cache)``

The layer stack is an ``nn.ModuleList`` walked by a Python loop (the
reference's ``lax.scan``). Weights are stored once in the dtype the
reference casts them to at each use (``layers.param_dtype``): the same
values with no per-step cast. ``loss_fn`` waits for the training slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

UNPORTED_FAMILIES = {
    "moe": "ROADMAP.md Queue A 14: MoE (qwen2-moe, arctic)",
    "hybrid": "ROADMAP.md Queue A 14: hybrid with ring-cache local attention (recurrentgemma)",
    "encdec": "ROADMAP.md Queue A 14: encdec (whisper)",
}


def _params(tree: dict, cfg: ModelConfig) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(v.to(L.param_dtype(k, cfg)), requires_grad=False) for k, v in tree.items()
    })


class _Block(nn.Module):
    """One layer: a ParameterDict per part (``ln_attn``, ``attn``, ...)."""

    def __init__(self, parts: dict, cfg: ModelConfig):
        super().__init__()
        for name, tree in parts.items():
            self.add_module(name, _params(tree, cfg))


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not carry yet."""
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}: {UNPORTED_FAMILIES[cfg.family]}")
    if cfg.family not in ("dense", "ssm"):
        raise ValueError(f"unknown family {cfg.family}")
    if cfg.attn_type == "mla":
        raise NotImplementedError("MLA attention: ROADMAP.md Queue A 14, MLA (minicpm3)")
    if cfg.modality != "text":
        raise NotImplementedError(f"{cfg.modality} prefix: ROADMAP.md Queue A 14, vision prefix")


class Model(nn.Module):
    """A decoder LM of the dense or SSM family with its weights.

    ``tree`` holds the parameters in the reference's layout, per layer:
    ``{"emb": {...}, "layers": [{"ln_attn": {...}, "attn": {...}, ...}, ...],
    "ln_f": {...}}``.
    """

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        check_supported(cfg)
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers given, the config has {cfg.n_layers}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.emb = _params(tree["emb"], cfg)
        self.layers = nn.ModuleList(_Block(lp, cfg) for lp in tree["layers"])
        self.ln_f = _params(tree["ln_f"], cfg)

    @property
    def device(self) -> torch.device:
        return self.emb["embed"].device

    # ------------------------------------------------------------- entry points

    def init_cache(self, batch: int, max_len: int) -> dict:
        if self.cfg.family == "ssm":
            return SSM.init_ssd_cache(self.cfg, batch, self.cfg.n_layers, device=self.device)
        return L.init_kv_cache(self.cfg, batch, max_len, self.cfg.n_layers, self.dtype,
                               self.device)

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict) -> tuple[torch.Tensor, dict]:
        x = L.embed_tokens(self.emb, self._tokens(batch["tokens"]), self.cfg, self.dtype)
        x, cache = self._run_with_cache(x, cache)
        return L.logits_from_hidden(self.emb, x[:, -1:], self.cfg), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict) -> tuple[torch.Tensor, dict]:
        x = L.embed_tokens(self.emb, self._tokens(tokens), self.cfg, self.dtype)
        x, cache = self._run_with_cache(x, cache)
        return L.logits_from_hidden(self.emb, x, self.cfg), cache

    # ------------------------------------------------------------------ stack

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)

    def _run_with_cache(self, x: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        cfg, pos, S = self.cfg, cache["pos"], x.shape[1]
        if cfg.family == "ssm":
            for i, layer in enumerate(self.layers):
                lc = {"conv": cache["conv"][i], "state": cache["state"][i], "pos": pos}
                out, _ = SSM.ssd_apply(layer.ssd, L.apply_norm(layer.ln, x, cfg.norm_type), cfg,
                                       cache=lc)
                x = x + out
        else:
            steps = torch.arange(S, device=self.device)
            # scalar pos → (S,) positions; per-slot vector pos → (B, S)
            positions = pos[:, None] + steps if pos.ndim == 1 else steps + int(pos)
            for i, layer in enumerate(self.layers):
                lc = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
                h = L.apply_norm(layer.ln_attn, x, cfg.norm_type)
                attn, _ = L.attention_apply(layer.attn, h, cfg, positions=positions, cache=lc)
                x = x + attn
                h = L.apply_norm(layer.ln_mlp, x, cfg.norm_type)
                x = x + L.mlp_apply(layer.mlp, h, cfg.mlp_act)
        x = L.apply_norm(self.ln_f, x, cfg.norm_type)
        return x, dict(cache, pos=pos + S)


def _init_tree(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random float32 parameters in the reference's layout (random init only:
    no weights are downloaded). The draws differ from ``jax.random``'s."""
    g = generator
    tree = {"emb": L.init_embeddings(g, cfg), "layers": []}
    for _ in range(cfg.n_layers):
        if cfg.family == "ssm":
            lp = {"ln": L.init_norm(cfg, g.device), "ssd": SSM.init_ssd(g, cfg)}
        else:
            lp = {"ln_attn": L.init_norm(cfg, g.device), "ln_mlp": L.init_norm(cfg, g.device),
                  "attn": L.init_attention(g, cfg), "mlp": L.init_mlp(g, cfg)}
        tree["layers"].append(lp)
    tree["ln_f"] = L.init_norm(cfg, g.device)
    return tree


def build_model(cfg: ModelConfig, *, device=None, seed: int = 0,
                generator: torch.Generator | None = None) -> Model:
    """A randomly initialised model on ``device`` (default: the CUDA device).
    The weights are drawn on the device from ``generator``, or from a
    generator there seeded with ``seed``."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    elif generator.device.type != dev.type:
        raise ValueError(f"the generator lies on {generator.device}, the model on {dev}")
    return Model(cfg, _init_tree(cfg, generator))
