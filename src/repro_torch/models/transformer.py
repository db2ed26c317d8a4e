"""Decoder-LM assembly (``repro/models/transformer.py``) for the families the
port serves and trains: dense (GQA or MLA attention), MoE, SSM (mamba2) and
the hybrid (recurrentgemma: super-blocks of ``cfg.block_pattern``, RG-LRU
and local-attention blocks each with an MLP).

``build_model(cfg)`` returns a :class:`Model`, an ``nn.Module`` that holds
its weights and keeps the reference's entry points:

  * ``loss_fn(batch) -> (loss, {"ce", "aux"})``: per-example-weighted CE
  * ``init_cache(batch, max_len) -> cache``
  * ``prefill(batch, cache) -> (logits_last, cache)``
  * ``decode_step(tokens, cache) -> (logits, cache)``

A serving model (the default) stores each weight once, per layer, in the
dtype the reference casts it to at each use (``layers.param_dtype``): the
same values with no per-step cast, and no gradients. Its build draws and
casts part by part (an expert stack expert by expert), so the build's peak
stays near the served bytes. A training model
(``train=True``) keeps float32 masters that take gradients, in the
reference's layout: the layers stacked on a leading axis, so
``param_tree()`` is the reference's parameter tree (its flatten order, its
checkpoint leaf names, adafactor's factored axes). Each forward casts the
stacked leaves to the activation dtype once and unbinds them into
per-layer views; autograd stacks the per-layer gradients back. The
hybrid's rec and attn blocks hold different leaves, so its masters are
stacked over the groups per block position of the pattern (``groups`` →
``b0``, ``b1``, ...), with the blocks of the last, partial group
unstacked (``tail``), as the reference's tree is.

The layer stack is a Python loop (the reference's ``lax.scan``). ``remat``
(training): "full" recomputes each layer (the hybrid: each group) in the
backward pass (``torch.utils.checkpoint``), "dots" saves only its matrix
products and recomputes the rest (a selective checkpoint, the reference's
``checkpoint_dots_with_no_batch_dims``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device, to_tensor
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

REMAT = ("none", "full", "dots")
# products without batch dims: what remat="dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

UNPORTED_FAMILIES = {
    "encdec": "ROADMAP.md Queue A 14: encdec (whisper)",
}


def _params(tree: dict, cfg: ModelConfig) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(v.to(L.param_dtype(k, cfg)), requires_grad=False) for k, v in tree.items()
    })


def _masters(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v.float()) for k, v in tree.items()})


def _stacked_masters(layers: list) -> nn.ModuleDict:
    """Float32 masters of ``layers`` (alike), each leaf stacked on a leading axis."""
    return nn.ModuleDict({
        part: _masters({k: torch.stack([lp[part][k] for lp in layers]) for k in leaves})
        for part, leaves in layers[0].items()
    })


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


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
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family}")
    if cfg.attn_type not in ("gqa", "mla"):
        raise ValueError(f"unknown attention type {cfg.attn_type}")
    if cfg.modality != "text":
        raise NotImplementedError(f"{cfg.modality} prefix: ROADMAP.md Queue A 14, vision prefix")


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(pattern length, groups, tail blocks) of a hybrid config: layer i is
    block i % plen of group i // plen, the last ``n_tail`` layers the
    unstacked tail."""
    plen = len(cfg.block_pattern)
    n_groups, n_tail = divmod(cfg.n_layers, plen)
    return plen, n_groups, n_tail


class Model(nn.Module):
    """A decoder LM of the dense, MoE, SSM or hybrid family with its weights.

    ``tree`` holds the parameters in the reference's layout, per layer:
    ``{"emb": {...}, "layers": [{"ln_attn": {...}, "attn": {...}, ...}, ...],
    "ln_f": {...}}`` (a hybrid's layers ``{"ln_mix", "mix", "ln_mlp",
    "mlp"}`` in layer order, the kind of layer i ``block_pattern[i % plen]``).
    """

    def __init__(self, cfg: ModelConfig, tree: dict, *, train: bool = False,
                 remat: str = "none", xent_chunk: int = 512):
        super().__init__()
        check_supported(cfg)
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers given, the config has {cfg.n_layers}")
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        if remat == "dots" and not hasattr(ckpt, "create_selective_checkpoint_contexts"):
            raise NotImplementedError(
                "remat='dots' needs torch.utils.checkpoint.create_selective_checkpoint_contexts "
                "(torch >= 2.4): ROADMAP.md Queue A 14.1")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.trainable = train
        self.remat = remat
        self.xent_chunk = xent_chunk
        # a layers.DropCounter here counts the MoE pairs dropped at capacity
        self.drop_counter = None
        if train and cfg.family == "hybrid":
            plen, n_groups, n_tail = hybrid_layout(cfg)
            layers = tree["layers"]
            self.emb = _masters(tree["emb"])
            self.stack = nn.ModuleDict({
                f"b{b}": _stacked_masters(layers[b:n_groups * plen:plen])
                for b in range(plen) if n_groups
            })
            self.tail = nn.ModuleDict({
                f"b{b}": nn.ModuleDict({part: _masters(leaves)
                                        for part, leaves in layers[n_groups * plen + b].items()})
                for b in range(n_tail)
            })
            self.ln_f = _masters(tree["ln_f"])
        elif train:
            self.emb = _masters(tree["emb"])
            self.stack = _stacked_masters(tree["layers"])
            self.ln_f = _masters(tree["ln_f"])
        else:
            self.emb = _params(tree["emb"], cfg)
            self.layers = nn.ModuleList(_Block(lp, cfg) for lp in tree["layers"])
            self.ln_f = _params(tree["ln_f"], cfg)

    @property
    def device(self) -> torch.device:
        return self.emb["embed"].device

    def param_tree(self) -> dict:
        """A training model's float32 masters as the reference's parameter
        tree: ``{"emb": {...}, "layers": {part: {leaf: (L, ...)}}, "ln_f": {...}}``,
        a hybrid's ``{"emb", "groups": {"b0": {part: {leaf: (G, ...)}}, ...},
        "tail": {"b0": {part: {leaf}}, ...}, "ln_f"}`` (the tensors themselves:
        an optimizer step updates them in place)."""
        if not self.trainable:
            raise ValueError("a serving model has no training masters: build it with train=True")
        if self.cfg.family == "hybrid":
            def parts(md):
                return {part: dict(pd.items()) for part, pd in md.items()}

            tree = {"emb": dict(self.emb.items()),
                    "groups": {b: parts(md) for b, md in self.stack.items()},
                    "ln_f": dict(self.ln_f.items())}
            if len(self.tail):
                tree["tail"] = {b: parts(md) for b, md in self.tail.items()}
            return tree
        return {"emb": dict(self.emb.items()),
                "layers": {part: dict(pd.items()) for part, pd in self.stack.items()},
                "ln_f": dict(self.ln_f.items())}

    # ------------------------------------------------------------- entry points

    def loss_fn(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Per-example-weighted CE of ``batch`` ("tokens", "labels" (B, S),
        optional "weights" (B,), default ones) through the layer stack with
        no cache: (loss, {"ce", "aux"}); the dense and MoE families add
        ``router_aux_coef``·aux/n_layers, aux the layers' summed router
        loss (0 without a router)."""
        cfg = self.cfg
        x = L.embed_tokens(self.emb, self._tokens(batch["tokens"]), cfg, self.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), device=x.device)
        if cfg.family == "hybrid":
            # remat per group, as the reference's scan body; the tail plain
            plen, n_groups, _ = hybrid_layout(cfg)
            lps = self._layer_params()
            group = self._remat(functools.partial(self._hybrid_blocks, positions=positions))
            for g in range(n_groups):
                x = group(x, lps[g * plen:(g + 1) * plen])
            x = self._hybrid_blocks(x, lps[n_groups * plen:], positions)
        else:
            layer = self._remat(functools.partial(self._layer, positions=positions))
            for lp in self._layer_params():
                x, a = layer(x, lp)
                if a is not None:
                    aux = aux + a
        x = L.apply_norm(self.ln_f, x, cfg.norm_type)
        table = self.emb["unembed"] if "unembed" in self.emb else self.emb["embed"]
        weights = batch.get("weights")
        weights = (torch.ones((x.shape[0],), device=x.device) if weights is None
                   else to_tensor(weights, torch.float32, x.device))
        ce = L.chunked_xent_weighted(x, table, self._tokens(batch["labels"]), weights,
                                     chunk=self.xent_chunk)
        if cfg.family in ("ssm", "hybrid"):
            return ce, {"ce": ce, "aux": aux}
        loss = ce + cfg.router_aux_coef * aux / max(cfg.n_layers, 1)
        return loss, {"ce": ce, "aux": aux}

    def init_cache(self, batch: int, max_len: int) -> dict:
        if self.cfg.family == "hybrid":
            return self._hybrid_cache(batch, max_len)
        if self.cfg.family == "ssm":
            return SSM.init_ssd_cache(self.cfg, batch, self.cfg.n_layers, device=self.device)
        if self.cfg.attn_type == "mla":
            return L.init_mla_cache(self.cfg, batch, max_len, self.cfg.n_layers, self.dtype,
                                    self.device)
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

    def _hybrid_cache(self, batch: int, max_len: int) -> dict:
        """The reference's nested layout: ``{"groups": {"b0": {...}, ...},
        "tail": {...}, "pos"}``, group leaves stacked (n_groups, B, ...), tail
        leaves (B, ...); an attn block's cache holds min(window, max_len)
        positions (a ring when the window is the shorter)."""
        cfg = self.cfg
        plen, n_groups, n_tail = hybrid_layout(cfg)
        length = min(cfg.attn_window or max_len, max_len)

        def block(kind: str, n: int) -> dict:
            if kind == "rec":
                c = RG.init_rglru_cache(cfg, batch, n, self.device)
            else:
                c = L.init_kv_cache(cfg, batch, length, n, self.dtype, self.device)
            return {k: v for k, v in c.items() if k != "pos"}

        cache = {"groups": {f"b{b}": block(kind, n_groups)
                            for b, kind in enumerate(cfg.block_pattern)}}
        if n_tail:
            cache["tail"] = {f"b{b}": {k: v[0] for k, v in block(kind, 1).items()}
                             for b, kind in enumerate(cfg.block_pattern[:n_tail])}
        cache["pos"] = torch.zeros((), dtype=torch.int32)
        return cache

    # ------------------------------------------------------------------ stack

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)

    def _layer_params(self) -> list[dict]:
        """Each layer's parameters, {part: {leaf: tensor}}, in layer order: a
        serving model's own, or views of a training model's stacked masters
        cast once to the dtype each is used in."""
        if not self.trainable:
            return [dict(layer.named_children()) for layer in self.layers]

        def views(stack: nn.ModuleDict, n: int) -> list[dict]:
            cast = {part: {k: v.to(L.param_dtype(k, self.cfg)).unbind(0) for k, v in pd.items()}
                    for part, pd in stack.items()}
            return [{part: {k: vs[i] for k, vs in leaves.items()}
                     for part, leaves in cast.items()} for i in range(n)]

        if self.cfg.family != "hybrid":
            return views(self.stack, self.cfg.n_layers)
        plen, n_groups, _ = hybrid_layout(self.cfg)
        by_block = [views(self.stack[f"b{b}"], n_groups) for b in range(plen) if n_groups]
        out = [by_block[b][g] for g in range(n_groups) for b in range(plen)]
        for md in self.tail.values():
            out.append({part: {k: v.to(L.param_dtype(k, self.cfg)) for k, v in pd.items()}
                        for part, pd in md.items()})
        return out

    def _remat(self, fn):
        """``fn`` under the model's ``remat`` policy (training)."""
        if self.remat == "full":
            return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
        if self.remat == "dots":
            return functools.partial(
                ckpt.checkpoint, fn, use_reentrant=False,
                context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _save_dots))
        return fn

    def _hybrid_block(self, kind: str, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                      cache=None):
        """One hybrid block (the reference's ``_block_apply``): (x, new_cache)."""
        cfg = self.cfg
        h = L.apply_norm(lp["ln_mix"], x, cfg.norm_type)
        if kind == "rec":
            out, new_cache = RG.rglru_block_apply(lp["mix"], h, cfg, cache=cache)
        else:
            out, new_cache = L.attention_apply(lp["mix"], h, cfg, positions=positions,
                                               cache=cache, window=cfg.attn_window)
        x = x + out
        h = L.apply_norm(lp["ln_mlp"], x, cfg.norm_type)
        return x + L.mlp_apply(lp["mlp"], h, cfg.mlp_act), new_cache

    def _hybrid_blocks(self, x: torch.Tensor, lps: list, positions: torch.Tensor):
        """Blocks 0, 1, ... of the pattern without a cache (a group, or the tail)."""
        for kind, lp in zip(self.cfg.block_pattern, lps):
            x, _ = self._hybrid_block(kind, lp, x, positions)
        return x

    def _layer(self, x: torch.Tensor, lp: dict, positions: torch.Tensor):
        """One layer without a cache (the training forward): (x, aux), aux
        the MoE router loss or None."""
        cfg = self.cfg
        if cfg.family == "ssm":
            out, _ = SSM.ssd_apply(lp["ssd"], L.apply_norm(lp["ln"], x, cfg.norm_type), cfg)
            return x + out, None
        x, _, aux = self._lm_layer(lp, x, positions)
        return x, aux

    def _lm_layer(self, lp: dict, x: torch.Tensor, positions: torch.Tensor, cache=None):
        """One decoder layer (the reference's ``_lm_layer``): (x, new_cache,
        aux), aux None outside the MoE family."""
        cfg = self.cfg
        h = L.apply_norm(lp["ln_attn"], x, cfg.norm_type)
        if cfg.attn_type == "mla":
            attn, new_cache = L.mla_apply(lp["attn"], h, cfg, positions=positions, cache=cache)
        else:
            attn, new_cache = L.attention_apply(lp["attn"], h, cfg, positions=positions,
                                                cache=cache)
        x = x + attn
        h = L.apply_norm(lp["ln_mlp"], x, cfg.norm_type)
        if cfg.family != "moe":
            return x + L.mlp_apply(lp["mlp"], h, cfg.mlp_act), new_cache, None
        mo, aux = L.moe_apply(lp["moe"], h, cfg, cfg.mlp_act, self.drop_counter)
        if cfg.n_shared_experts > 0:
            mo = mo + L.mlp_apply(lp["shared"], h, cfg.mlp_act)
        if cfg.moe_dense_residual:
            mo = mo + L.mlp_apply(lp["dense"], h, cfg.mlp_act)
        return x + mo, new_cache, aux

    def _run_with_cache(self, x: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        cfg, pos, S = self.cfg, cache["pos"], x.shape[1]
        steps = torch.arange(S, device=self.device)
        # scalar pos → (S,) positions; per-slot vector pos → (B, S)
        positions = pos[:, None] + steps if pos.ndim == 1 else steps + int(pos)
        if cfg.family == "hybrid":
            plen, n_groups, _ = hybrid_layout(cfg)
            for i, lp in enumerate(self._layer_params()):
                g, b = divmod(i, plen)
                if g < n_groups:  # views of the group-stacked leaves, written in place
                    lc = {k: v[g] for k, v in cache["groups"][f"b{b}"].items()}
                else:
                    lc = dict(cache["tail"][f"b{b}"])
                x, _ = self._hybrid_block(cfg.block_pattern[b], lp, x, positions,
                                          dict(lc, pos=pos))
        elif cfg.family == "ssm":
            for i, lp in enumerate(self._layer_params()):
                lc = {"conv": cache["conv"][i], "state": cache["state"][i], "pos": pos}
                out, _ = SSM.ssd_apply(lp["ssd"], L.apply_norm(lp["ln"], x, cfg.norm_type), cfg,
                                       cache=lc)
                x = x + out
        else:
            for i, lp in enumerate(self._layer_params()):
                lc = {k: v[i] for k, v in cache.items() if k != "pos"}
                x, _, _ = self._lm_layer(lp, x, positions, dict(lc, pos=pos))
        x = L.apply_norm(self.ln_f, x, cfg.norm_type)
        return x, dict(cache, pos=pos + S)


def _init_tree(cfg: ModelConfig, generator: torch.Generator, cast: bool = False) -> dict:
    """Random parameters in the reference's layout (random init only: no
    weights are downloaded), drawn in float32; the draws differ from
    ``jax.random``'s. ``cast``: each part is cast to the dtypes a serving
    model stores (``layers.param_dtype``) as soon as it is drawn, and the
    expert stacks are drawn expert by expert into the activation dtype, so
    the peak stays within one part's float32 draw of the served bytes."""
    g = generator

    def part(tree: dict) -> dict:
        return {k: v.to(L.param_dtype(k, cfg)) for k, v in tree.items()} if cast else tree

    tree = {"emb": part(L.init_embeddings(g, cfg)), "layers": []}
    for i in range(cfg.n_layers):
        if cfg.family == "hybrid":
            kind = cfg.block_pattern[i % len(cfg.block_pattern)]
            lp = {"ln_mix": part(L.init_norm(cfg, g.device)),
                  "ln_mlp": part(L.init_norm(cfg, g.device)),
                  "mix": part(RG.init_rglru_block(g, cfg) if kind == "rec"
                              else L.init_attention(g, cfg)),
                  "mlp": part(L.init_mlp(g, cfg))}
        elif cfg.family == "ssm":
            lp = {"ln": part(L.init_norm(cfg, g.device)), "ssd": part(SSM.init_ssd(g, cfg))}
        else:
            lp = {"ln_attn": part(L.init_norm(cfg, g.device)),
                  "ln_mlp": part(L.init_norm(cfg, g.device)),
                  "attn": part(L.init_mla(g, cfg) if cfg.attn_type == "mla"
                               else L.init_attention(g, cfg))}
            if cfg.family == "moe":
                lp["moe"] = part(L.init_moe(g, cfg, getattr(torch, cfg.dtype) if cast
                                            else torch.float32))
                if cfg.n_shared_experts > 0:
                    lp["shared"] = part(L.init_mlp(g, cfg, d_ff=cfg.d_ff * cfg.n_shared_experts))
                if cfg.moe_dense_residual:
                    lp["dense"] = part(L.init_mlp(g, cfg))
            else:
                lp["mlp"] = part(L.init_mlp(g, cfg))
        tree["layers"].append(lp)
    tree["ln_f"] = part(L.init_norm(cfg, g.device))
    return tree


def build_model(cfg: ModelConfig, *, device=None, seed: int = 0,
                generator: torch.Generator | None = None, train: bool = False,
                remat: str = "none", xent_chunk: int = 512) -> Model:
    """A randomly initialised model on ``device`` (default: the CUDA device).
    The weights are drawn on the device from ``generator``, or from a
    generator there seeded with ``seed``. ``train``: float32 masters that
    take gradients (see the module doc); ``remat`` and ``xent_chunk`` (the
    CE's sequence chunk) are the reference's ``build_model`` options."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    elif generator.device.type != dev.type:
        raise ValueError(f"the generator lies on {generator.device}, the model on {dev}")
    return Model(cfg, _init_tree(cfg, generator, cast=not train), train=train, remat=remat,
                 xent_chunk=xent_chunk)
