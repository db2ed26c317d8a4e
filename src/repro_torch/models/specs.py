"""Logical sharding specs of the LM's parameters and caches — what the
reference's ``init`` and ``init_cache`` return beside the arrays
(``repro/models/layers.py``, ``ssm.py``, ``rglru.py``, ``encdec.py``,
``transformer.py``).

A spec is a plain tuple of logical axis names, one a dim
(``distributed/sharding.py`` resolves it on a mesh). ``param_specs``
mirrors a parameter tree: the training layout's stacked leaves (``layers``,
a hybrid's ``groups``, an encdec's ``enc`` and ``dec``) carry a leading
"layer"; the serving layout's per-layer lists and a hybrid's unstacked
``tail`` do not. ``cache_specs`` mirrors ``init_cache``'s cache.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

__all__ = ["param_specs", "cache_specs", "STACKED"]

NORM = {"scale": ("embed",), "bias": ("embed",)}
EMB = {"embed": ("vocab", "embed"), "unembed": ("vocab", "embed")}
ATTN = {
    "wq": ("embed", "heads", None),
    "wk": ("embed", "kv", None),
    "wv": ("embed", "kv", None),
    "wo": ("heads", None, "embed"),
}
MLA = {
    "wdq": ("embed", None),
    "q_norm": (None,),
    "wuq": (None, "heads", None),
    "wdkv": ("embed", None),
    "kv_norm": (None,),
    "wkr": ("embed", None),
    "wuk": (None, "heads", None),
    "wuv": (None, "heads", None),
    "wo": ("heads", None, "embed"),
}
MLP = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"), "wo": ("mlp", "embed")}
MOE = {
    "router": ("embed", None),
    "wi_gate": ("expert", "embed", "mlp"),
    "wi_up": ("expert", "embed", "mlp"),
    "wo": ("expert", "mlp", "embed"),
}
SSD = {
    "in_proj": ("embed", "heads"),
    "conv_w": (None, "heads"),
    "conv_b": ("heads",),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "norm_scale": ("heads",),
    "out_proj": ("heads", "embed"),
}
RGLRU = {
    "gate_proj": ("embed", "lru"),
    "rec_proj": ("embed", "lru"),
    "conv_w": (None, "lru"),
    "conv_b": ("lru",),
    "wa": (None, "lru"),
    "ba": ("lru",),
    "wx": (None, "lru"),
    "bx": ("lru",),
    "lam": ("lru",),
    "out_proj": ("lru", "embed"),
}

# the training layout's keys whose dict values are stacked over layers
STACKED = ("layers", "groups", "enc", "dec")


def _table(part: str, leaves) -> dict:
    """The spec table of a part, by its name (and, for the mixers, by its
    leaves: an RG-LRU block, MLA or GQA attention)."""
    if part == "emb":
        return EMB
    if part.startswith("ln"):
        return NORM
    if part in ("mlp", "shared", "dense"):
        return MLP
    if part == "moe":
        return MOE
    if part == "ssd":
        return SSD
    if part in ("attn", "mix", "self", "cross"):
        if "gate_proj" in leaves:
            return RGLRU
        return MLA if "wdq" in leaves else ATTN
    raise ValueError(f"no spec table for the part {part!r}")


def _is_part(node) -> bool:
    return isinstance(node, dict) and all(hasattr(v, "shape") for v in node.values())


def param_specs(tree) -> dict:
    """The logical specs of a parameter tree, its structure (module doc)."""

    def walk(node, name: str, prefix: tuple):
        if isinstance(node, list):
            return [walk(x, name, prefix) for x in node]
        if _is_part(node):
            table = _table(name, node)
            return {k: prefix + table[k] for k in node}
        return {k: walk(v, k, prefix + (("layer",) if k in STACKED and isinstance(v, dict)
                                        else ())) for k, v in node.items()}

    return walk(tree, "", ())


def _kv(cfg: ModelConfig, prefix: tuple) -> dict:
    seq = "seq_kv" if cfg.decode_seq_shard else None
    spec = prefix + ("batch", seq, "kv", None)
    return {"k": spec, "v": spec}


def cache_specs(cfg: ModelConfig) -> dict:
    """The logical specs of ``init_cache``'s cache for ``cfg`` (the
    reference's, "pos" included as ())."""
    seq = "seq_kv" if cfg.decode_seq_shard else None
    if cfg.family == "encdec":
        kv = ("layer", "batch", None, "kv", None)
        cross = ("layer", "batch", seq, "kv", None)
        return {"self": {"k": kv, "v": kv}, "cross_k": cross, "cross_v": cross, "pos": ()}
    if cfg.family == "ssm":
        return {"conv": ("layer", "batch", None, "heads"),
                "state": ("layer", "batch", "heads", None, None), "pos": ()}
    if cfg.family == "hybrid":
        plen = len(cfg.block_pattern)
        n_groups, n_tail = divmod(cfg.n_layers, plen)

        def block(kind: str, prefix: tuple) -> dict:
            if kind == "rec":
                return {"conv": prefix + ("batch", None, "lru"), "h": prefix + ("batch", "lru")}
            return _kv(cfg, prefix)

        out = {"groups": {f"b{b}": block(kind, ("layer",))
                          for b, kind in enumerate(cfg.block_pattern)}}
        if n_tail:
            out["tail"] = {f"b{b}": block(kind, ())
                           for b, kind in enumerate(cfg.block_pattern[:n_tail])}
        out["pos"] = ()
        return out
    if cfg.attn_type == "mla":
        return {"ckv": ("layer", "batch", seq, None),
                "krope": ("layer", "batch", seq, None, None), "pos": ()}
    return dict(_kv(cfg, ("layer",)), pos=())
