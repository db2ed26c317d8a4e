"""LM assembly (``repro/models/transformer.py``) for every family of the
reference: dense (GQA or MLA attention; with a vision config, stub patch
embeddings prepended to the text), MoE, SSM (mamba2), the hybrid
(recurrentgemma: super-blocks of ``cfg.block_pattern``, RG-LRU and
local-attention blocks each with an MLP) and the encoder-decoder (whisper:
a bidirectional rope-free encoder over stub frame embeddings, a decoder of
rope-free causal self-attention and cross-attention).

``build_model(cfg)`` returns a :class:`Model` (an :class:`EncDecModel` for
the encdec family), an ``nn.Module`` that holds its weights and keeps the
reference's entry points:

  * ``loss_fn(batch) -> (loss, {"ce", "aux"})``: per-example-weighted CE
  * ``init_cache(batch, max_len) -> cache``
  * ``prefill(batch, cache) -> (logits_last, cache)``
  * ``decode_step(tokens, cache) -> (logits, cache)``

A vision config's ``batch`` may carry "patch_embeds" (B, P, d): they are
prepended to the token embeddings (positions 0 .. P + S − 1), and the loss
drops the first P positions; ``decode_step`` takes tokens only.

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
from repro_torch.distributed.sharding import fsdp_gather, reduce_partial
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

REMAT = ("none", "full", "dots")
# products without batch dims: what remat="dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
MODALITIES = ("text", "vision", "audio")


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


def _residual(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """x + a block's output, its pending sums reduced first on a sharded
    run (redistribution point "residual", ``sharding.reduce_partial``)."""
    return x + reduce_partial("residual", out)


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
    """Raise ``ValueError`` for a config no family of the reference builds."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    if cfg.attn_type not in ("gqa", "mla"):
        raise ValueError(f"unknown attention type {cfg.attn_type}")
    if cfg.modality not in MODALITIES:
        raise ValueError(f"unknown modality {cfg.modality}")


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(pattern length, groups, tail blocks) of a hybrid config: layer i is
    block i % plen of group i // plen, the last ``n_tail`` layers the
    unstacked tail."""
    plen = len(cfg.block_pattern)
    n_groups, n_tail = divmod(cfg.n_layers, plen)
    return plen, n_groups, n_tail


class _LM(nn.Module):
    """What every family's model shares: the config, the activation dtype,
    the training options, and the helpers of the entry points."""

    def __init__(self, cfg: ModelConfig, *, train: bool, remat: str, xent_chunk: int):
        super().__init__()
        check_supported(cfg)
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

    @property
    def device(self) -> torch.device:
        return self.emb["embed"].device

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)

    def _stub(self, x) -> torch.Tensor:
        """A modality stub's embeddings (patches, frames) in the activation
        dtype on the model's device (the reference's ``astype(dtype)``)."""
        return to_tensor(x, None, self.device).to(self.dtype)

    def _views(self, stack: nn.ModuleDict, n: int) -> list[dict]:
        """Per-layer views, {part: {leaf: tensor}}, of stacked training
        masters, each leaf cast once to the dtype it is used in."""
        cast = {part: {k: v.to(L.param_dtype(k, self.cfg)).unbind(0) for k, v in pd.items()}
                for part, pd in stack.items()}
        return [{part: {k: vs[i] for k, vs in leaves.items()}
                 for part, leaves in cast.items()} for i in range(n)]

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

    def _xent(self, x: torch.Tensor, batch: dict) -> torch.Tensor:
        """The per-example-weighted CE of the final hidden states x against
        ``batch["labels"]`` (weights default to ones)."""
        table = self.emb["unembed"] if "unembed" in self.emb else self.emb["embed"]
        weights = batch.get("weights")
        weights = (torch.ones((x.shape[0],), device=x.device) if weights is None
                   else to_tensor(weights, torch.float32, x.device))
        return L.chunked_xent_weighted(x, table, self._tokens(batch["labels"]), weights,
                                       chunk=self.xent_chunk)


class Model(_LM):
    """A decoder LM of the dense, MoE, SSM or hybrid family with its weights.

    ``tree`` holds the parameters in the reference's layout, per layer:
    ``{"emb": {...}, "layers": [{"ln_attn": {...}, "attn": {...}, ...}, ...],
    "ln_f": {...}}`` (a hybrid's layers ``{"ln_mix", "mix", "ln_mlp",
    "mlp"}`` in layer order, the kind of layer i ``block_pattern[i % plen]``).
    """

    def __init__(self, cfg: ModelConfig, tree: dict, *, train: bool = False,
                 remat: str = "none", xent_chunk: int = 512):
        super().__init__(cfg, train=train, remat=remat, xent_chunk=xent_chunk)
        if cfg.family == "encdec":
            raise ValueError("an encdec config builds an EncDecModel")
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers given, the config has {cfg.n_layers}")
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
        optional "weights" (B,), default ones; a vision config's optional
        "patch_embeds" (B, P, d), whose positions the CE skips) through the
        layer stack with no cache: (loss, {"ce", "aux"}); the dense and MoE
        families add ``router_aux_coef``·aux/n_layers, aux the layers' summed
        router loss (0 without a router)."""
        cfg = self.cfg
        x = self._embed(batch)
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
        x = x[:, x.shape[1] - batch["tokens"].shape[1]:]  # the text positions
        ce = self._xent(x, batch)
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
        """``batch``: "tokens" (B, S), and a vision config's optional
        "patch_embeds" (B, P, d) before them; the cache advances P + S."""
        x, cache = self._run_with_cache(self._embed(batch), cache)
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

    def _embed(self, batch: dict) -> torch.Tensor:
        """Token embeddings, with a vision config's patch prefix when the
        batch carries one (the reference's ``_embed_with_prefix``; the dense
        and MoE families)."""
        x = L.embed_tokens(self.emb, self._tokens(batch["tokens"]), self.cfg, self.dtype)
        if (self.cfg.modality == "vision" and "patch_embeds" in batch
                and self.cfg.family in ("dense", "moe")):
            x = torch.cat([self._stub(batch["patch_embeds"]), x], 1)
        return x

    def _layer_params(self) -> list[dict]:
        """Each layer's parameters, {part: {leaf: tensor}}, in layer order: a
        serving model's own, or views of a training model's stacked masters
        cast once to the dtype each is used in."""
        if not self.trainable:
            return [dict(layer.named_children()) for layer in self.layers]
        if self.cfg.family != "hybrid":
            return self._views(self.stack, self.cfg.n_layers)
        plen, n_groups, _ = hybrid_layout(self.cfg)
        by_block = [self._views(self.stack[f"b{b}"], n_groups) for b in range(plen) if n_groups]
        out = [by_block[b][g] for g in range(n_groups) for b in range(plen)]
        for md in self.tail.values():
            out.append({part: {k: v.to(L.param_dtype(k, self.cfg)) for k, v in pd.items()}
                        for part, pd in md.items()})
        return out

    def _hybrid_block(self, kind: str, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                      cache=None):
        """One hybrid block (the reference's ``_block_apply``): (x, new_cache)."""
        cfg = self.cfg
        lp = fsdp_gather("fsdp_gather", lp, x)
        h = L.apply_norm(lp["ln_mix"], x, cfg.norm_type)
        if kind == "rec":
            out, new_cache = RG.rglru_block_apply(lp["mix"], h, cfg, cache=cache)
        else:
            out, new_cache = L.attention_apply(lp["mix"], h, cfg, positions=positions,
                                               cache=cache, window=cfg.attn_window)
        x = _residual(x, out)
        h = L.apply_norm(lp["ln_mlp"], x, cfg.norm_type)
        return _residual(x, L.mlp_apply(lp["mlp"], h, cfg.mlp_act)), new_cache

    def _hybrid_blocks(self, x: torch.Tensor, lps: list, positions: torch.Tensor):
        """Blocks 0, 1, ... of the pattern without a cache (a group, or the tail)."""
        for kind, lp in zip(self.cfg.block_pattern, lps):
            x, _ = self._hybrid_block(kind, lp, x, positions)
        return x

    def _layer(self, x: torch.Tensor, lp: dict, positions: torch.Tensor):
        """One layer without a cache (the training forward): (x, aux), aux
        the MoE router loss or None."""
        cfg = self.cfg
        lp = fsdp_gather("fsdp_gather", lp, x)
        if cfg.family == "ssm":
            out, _ = SSM.ssd_apply(lp["ssd"], L.apply_norm(lp["ln"], x, cfg.norm_type), cfg)
            return _residual(x, out), None
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
        x = _residual(x, attn)
        h = L.apply_norm(lp["ln_mlp"], x, cfg.norm_type)
        if cfg.family != "moe":
            return _residual(x, L.mlp_apply(lp["mlp"], h, cfg.mlp_act)), new_cache, None
        mo, aux = L.moe_apply(lp["moe"], h, cfg, cfg.mlp_act, self.drop_counter)
        if cfg.n_shared_experts > 0:
            mo = mo + L.mlp_apply(lp["shared"], h, cfg.mlp_act)
        if cfg.moe_dense_residual:
            mo = mo + L.mlp_apply(lp["dense"], h, cfg.mlp_act)
        return _residual(x, mo), new_cache, aux

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
                x = _residual(x, out)
        else:
            for i, lp in enumerate(self._layer_params()):
                lc = {k: v[i] for k, v in cache.items() if k != "pos"}
                x, _, _ = self._lm_layer(lp, x, positions, dict(lc, pos=pos))
        x = L.apply_norm(self.ln_f, x, cfg.norm_type)
        return x, dict(cache, pos=pos + S)


class EncDecModel(_LM):
    """The encoder-decoder (whisper) with its weights, the reference's
    ``_build_encdec``: ``tree`` is ``{"emb": {...}, "enc": [{"ln_attn",
    "attn", "ln_mlp", "mlp"}, ...], "dec": [{"ln_self", "self", "ln_cross",
    "cross", "ln_mlp", "mlp"}, ...], "ln_enc": {...}, "ln_dec": {...}}``.

    The encoder attends bidirectionally without rope over the frames plus
    sinusoid positions (through the flash-attention kernel, non-causal, when
    serving); the decoder's self-attention is causal and rope-free over a
    linear cache of ``cfg.dec_max_len`` positions, its positions sinusoid,
    and its cross-attention attends the encoder's output. Where the
    reference clamps a write or a position slice past ``dec_max_len``, the
    port raises ``ValueError``. The cache is ``{"self": {"k", "v"}: (Ld, B,
    dec_max_len, KV, hd), "cross_k", "cross_v": (Ld, B, T, KV, hd), "pos"}``
    with a scalar host-side ``pos``; ``ServeEngine`` refuses the family, as
    the reference's does, so requests go through these entry points.
    """

    def __init__(self, cfg: ModelConfig, tree: dict, *, train: bool = False,
                 remat: str = "none", xent_chunk: int = 512):
        super().__init__(cfg, train=train, remat=remat, xent_chunk=xent_chunk)
        if cfg.family != "encdec":
            raise ValueError(f"EncDecModel builds the encdec family, not {cfg.family!r}")
        if (len(tree["enc"]), len(tree["dec"])) != (cfg.n_enc_layers, cfg.n_dec_layers):
            raise ValueError(f"{len(tree['enc'])} encoder and {len(tree['dec'])} decoder layers "
                             f"given, the config has {cfg.n_enc_layers} and {cfg.n_dec_layers}")
        if train:
            self.emb = _masters(tree["emb"])
            self.enc = _stacked_masters(tree["enc"]) if tree["enc"] else nn.ModuleDict()
            self.dec = _stacked_masters(tree["dec"]) if tree["dec"] else nn.ModuleDict()
            self.ln_enc, self.ln_dec = _masters(tree["ln_enc"]), _masters(tree["ln_dec"])
        else:
            self.emb = _params(tree["emb"], cfg)
            self.enc = nn.ModuleList(_Block(lp, cfg) for lp in tree["enc"])
            self.dec = nn.ModuleList(_Block(lp, cfg) for lp in tree["dec"])
            self.ln_enc, self.ln_dec = _params(tree["ln_enc"], cfg), _params(tree["ln_dec"], cfg)
        # sinusoid position tables on the device, by length: a decode step
        # reads a slice with no host-to-device copy
        self._pe: dict = {}

    def param_tree(self) -> dict:
        """A training model's float32 masters as the reference's parameter
        tree: ``{"emb", "enc": {part: {leaf: (Le, ...)}}, "dec": {part: {leaf:
        (Ld, ...)}}, "ln_enc", "ln_dec"}`` (the tensors themselves)."""
        if not self.trainable:
            raise ValueError("a serving model has no training masters: build it with train=True")
        return {"emb": dict(self.emb.items()),
                "enc": {part: dict(pd.items()) for part, pd in self.enc.items()},
                "dec": {part: dict(pd.items()) for part, pd in self.dec.items()},
                "ln_enc": dict(self.ln_enc.items()), "ln_dec": dict(self.ln_dec.items())}

    # ------------------------------------------------------------- entry points

    def encode(self, frames) -> torch.Tensor:
        """The encoder's output (B, T, d) of stub frame embeddings (B, T, d)."""
        cfg = self.cfg
        x = self._stub(frames)
        T = x.shape[1]
        x = x + self._positions(T)[None]
        layer = self._remat(functools.partial(self._enc_layer,
                                              positions=torch.arange(T, device=self.device)))
        for lp in self._layer_params("enc"):
            x = layer(x, lp)
        return L.apply_norm(self.ln_enc, x, cfg.norm_type)

    def decode_hidden(self, tokens, memory: torch.Tensor | None = None,
                      cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
        """The decoder's final hidden states of ``tokens`` (B, S): without a
        cache over the encoder's output ``memory`` (training, positions 0 ..
        S − 1; returns None for the cache), or with one from its ``pos``
        (the cross K/V in the cache; the cache written in place)."""
        cfg = self.cfg
        x = L.embed_tokens(self.emb, self._tokens(tokens), cfg, self.dtype)
        S = x.shape[1]
        if cache is None:
            x = x + self._positions(S)[None]
            layer = self._remat(functools.partial(
                self._dec_layer_full, positions=torch.arange(S, device=self.device),
                memory=memory))
            for lp in self._layer_params("dec"):
                x = layer(x, lp)
            new_cache = None
        else:
            pos = cache["pos"]
            if pos.ndim:
                raise ValueError("the encdec decoder takes a scalar cache pos")
            p = int(pos)
            if p + S > cfg.dec_max_len:
                raise ValueError(f"decoder positions {p}..{p + S - 1} run past dec_max_len = "
                                 f"{cfg.dec_max_len}")
            x = x + self._positions(cfg.dec_max_len)[p:p + S][None]
            positions = p + torch.arange(S, device=self.device)
            for i, lp in enumerate(self._layer_params("dec")):
                sc = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i], "pos": pos}
                x, _ = self._dec_layer(lp, x, positions, sc, cache["cross_k"][i],
                                       cache["cross_v"][i])
            new_cache = dict(cache, pos=pos + S)
        return L.apply_norm(self.ln_dec, x, cfg.norm_type), new_cache

    def loss_fn(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Per-example-weighted CE of ``batch`` ("frames" (B, T, d), "tokens",
        "labels" (B, S), optional "weights" (B,)): (loss, {"ce", "aux"}), aux
        0."""
        x, _ = self.decode_hidden(batch["tokens"], self.encode(batch["frames"]), None)
        ce = self._xent(x, batch)
        return ce, {"ce": ce, "aux": torch.zeros((), device=x.device)}

    def init_cache(self, batch: int, max_len: int, enc_len: int | None = None) -> dict:
        """The decoder's self-attention cache of ``cfg.dec_max_len`` positions
        (``max_len`` sizes the cross K/V when ``enc_len`` is not given, as in
        the reference), zeros, and a scalar host-side ``pos``."""
        cfg = self.cfg
        enc_len = enc_len or max_len
        Ld, KV, hd = cfg.n_dec_layers, cfg.n_kv_heads, cfg.head_dim

        def zeros(T):
            return torch.zeros((Ld, batch, T, KV, hd), dtype=self.dtype, device=self.device)

        return {"self": {"k": zeros(cfg.dec_max_len), "v": zeros(cfg.dec_max_len)},
                "cross_k": zeros(enc_len), "cross_v": zeros(enc_len),
                "pos": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict) -> tuple[torch.Tensor, dict]:
        """Encode ``batch["frames"]``, install every layer's cross K/V in the
        cache (of the frames' length, replacing the cache's), then prefill
        the decoder prompt ``batch["tokens"]``: (last logits, cache)."""
        memory = self.encode(batch["frames"])
        kv = [ED.cross_kv(lp["cross"], memory) for lp in self._layer_params("dec")]
        cache = dict(cache, cross_k=torch.stack([k for k, _ in kv]).to(self.dtype),
                     cross_v=torch.stack([v for _, v in kv]).to(self.dtype))
        logits, cache = self.decode_step(batch["tokens"], cache)
        return logits[:, -1:], cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict) -> tuple[torch.Tensor, dict]:
        x, cache = self.decode_hidden(tokens, None, cache)
        return L.logits_from_hidden(self.emb, x, self.cfg), cache

    # ------------------------------------------------------------------ stack

    def _positions(self, T: int) -> torch.Tensor:
        """``encdec.sinusoid_pos(T, d_model)`` in the activation dtype on the
        model's device, kept by (length, device)."""
        key = (T, self.device)
        if key not in self._pe:
            self._pe[key] = ED.sinusoid_pos(T, self.cfg.d_model, self.dtype, self.device)
        return self._pe[key]

    def _layer_params(self, which: str) -> list[dict]:
        """The encoder's ("enc") or decoder's ("dec") layer parameters in
        layer order: a serving model's own, or views of the stacked masters."""
        stack = getattr(self, which)
        if not self.trainable:
            return [dict(layer.named_children()) for layer in stack]
        n = self.cfg.n_enc_layers if which == "enc" else self.cfg.n_dec_layers
        return self._views(stack, n) if n else []

    def _enc_layer(self, x: torch.Tensor, lp: dict, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        lp = fsdp_gather("fsdp_gather", lp, x)
        h = L.apply_norm(lp["ln_attn"], x, cfg.norm_type)
        a, _ = L.attention_apply(lp["attn"], h, cfg, positions=positions, bidirectional=True,
                                 use_rope=False)
        x = _residual(x, a)
        h = L.apply_norm(lp["ln_mlp"], x, cfg.norm_type)
        return _residual(x, L.mlp_apply(lp["mlp"], h, cfg.mlp_act))

    def _dec_layer(self, lp: dict, x: torch.Tensor, positions: torch.Tensor, self_cache,
                   ck: torch.Tensor, cv: torch.Tensor):
        """One decoder layer (the reference's ``_dec_layer``): (x, new_cache)."""
        cfg = self.cfg
        lp = fsdp_gather("fsdp_gather", lp, x)
        h = L.apply_norm(lp["ln_self"], x, cfg.norm_type)
        a, new_cache = L.attention_apply(lp["self"], h, cfg, positions=positions,
                                         cache=self_cache, use_rope=False)
        x = _residual(x, a)
        h = L.apply_norm(lp["ln_cross"], x, cfg.norm_type)
        x = _residual(x, ED.cross_attention_apply(lp["cross"], h, ck, cv, cfg))
        h = L.apply_norm(lp["ln_mlp"], x, cfg.norm_type)
        return _residual(x, L.mlp_apply(lp["mlp"], h, cfg.mlp_act)), new_cache

    def _dec_layer_full(self, x: torch.Tensor, lp: dict, positions: torch.Tensor,
                        memory: torch.Tensor) -> torch.Tensor:
        """A decoder layer without a cache, its cross K/V from ``memory``."""
        lp = fsdp_gather("fsdp_gather", lp, x)
        ck, cv = ED.cross_kv(lp["cross"], memory)
        return self._dec_layer(lp, x, positions, None, ck, cv)[0]


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

    if cfg.family == "encdec":
        def norms(*names):
            return {n: part(L.init_norm(cfg, g.device)) for n in names}

        return {"emb": part(L.init_embeddings(g, cfg)),
                "enc": [dict(norms("ln_attn", "ln_mlp"), attn=part(L.init_attention(g, cfg)),
                             mlp=part(L.init_mlp(g, cfg))) for _ in range(cfg.n_enc_layers)],
                "dec": [dict(norms("ln_self", "ln_cross", "ln_mlp"),
                             self=part(L.init_attention(g, cfg)),
                             cross=part(ED.init_cross_attention(g, cfg)),
                             mlp=part(L.init_mlp(g, cfg))) for _ in range(cfg.n_dec_layers)],
                **norms("ln_enc", "ln_dec")}
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
                remat: str = "none", xent_chunk: int = 512) -> Model | EncDecModel:
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
    cls = EncDecModel if cfg.family == "encdec" else Model
    return cls(cfg, _init_tree(cfg, generator, cast=not train), train=train, remat=remat,
               xent_chunk=xent_chunk)


def shapes_and_specs(model_or_cfg, *, serving: bool = False):
    """(tree of meta tensors, logical specs) of a model's parameters, with
    nothing allocated: the reference's ``shapes_and_specs``. Given a config
    (or a model, for its config): the training layout (float32, stacked
    over "layer", as ``param_tree()``), or with ``serving`` the serving
    layout (per-layer lists, the dtypes a serving model stores, specs
    without "layer"). The tree is drawn under ``FakeTensorMode`` and
    handed back on the meta device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.specs import param_specs

    cfg = model_or_cfg.cfg if isinstance(model_or_cfg, _LM) else model_or_cfg
    check_supported(cfg)
    with FakeTensorMode():
        tree = _init_tree(cfg, torch.Generator(), cast=serving)
        if not serving:
            tree = _stacked_tree(cfg, tree)
    shapes = _meta(tree)
    return shapes, param_specs(shapes)


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _stacked_tree(cfg: ModelConfig, tree: dict) -> dict:
    """``_init_tree``'s per-layer tree in the training layout of
    ``param_tree()`` (float32, stacked over layers)."""

    def stack(layers: list) -> dict:
        return {part: {k: torch.stack([lp[part][k] for lp in layers]).float() for k in leaves}
                for part, leaves in layers[0].items()}

    def f32(part: dict) -> dict:
        return {k: v.float() for k, v in part.items()}

    if cfg.family == "encdec":
        return {"emb": f32(tree["emb"]),
                "enc": stack(tree["enc"]) if tree["enc"] else {},
                "dec": stack(tree["dec"]) if tree["dec"] else {},
                "ln_enc": f32(tree["ln_enc"]), "ln_dec": f32(tree["ln_dec"])}
    out = {"emb": f32(tree["emb"])}
    if cfg.family == "hybrid":
        plen, n_groups, n_tail = hybrid_layout(cfg)
        layers = tree["layers"]
        if n_groups:
            out["groups"] = {f"b{b}": stack(layers[b:n_groups * plen:plen]) for b in range(plen)}
        if n_tail:
            out["tail"] = {f"b{b}": {part: f32(leaves) for part, leaves
                                     in layers[n_groups * plen + b].items()}
                           for b in range(n_tail)}
    else:
        out["layers"] = stack(tree["layers"])
    out["ln_f"] = f32(tree["ln_f"])
    return out


def cache_shapes_and_specs(cfg: ModelConfig, batch: int, max_len: int):
    """(tree of meta tensors, logical specs) of ``init_cache(batch,
    max_len)``'s cache for ``cfg`` (the reference's ``init_cache`` pair),
    with nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.specs import cache_specs

    with FakeTensorMode():
        model = _CacheShapes(cfg)
        cache = (EncDecModel.init_cache(model, batch, max_len) if cfg.family == "encdec"
                 else Model.init_cache(model, batch, max_len))
    return _meta(cache), cache_specs(cfg)


class _CacheShapes:
    """What ``init_cache`` reads of a model: its config, dtype and device."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.device = torch.device("cpu")

    def _hybrid_cache(self, batch: int, max_len: int) -> dict:
        return Model._hybrid_cache(self, batch, max_len)
