"""Roofline terms for the port's dry runs on the NVIDIA H100 — the port of
``repro.launch.roofline``.

Convention (the reference's): the traced program is **one rank's**, so its
FLOPs, bytes and collective bytes are per-device quantities, and the three
terms (seconds) are

    compute    = per_device_FLOPs   / PEAK_FLOPS
    memory     = per_device_bytes   / HBM_BW
    collective = per_device_coll_B  / ICI_BW

The constants are the H100 SXM data sheet's peaks, not measurements: bf16
dense tensor-core FLOP/s, HBM3 bytes/s, and one direction of NVLink 4 (the
chip-to-chip link, in the reference's ICI's place). ``chip_smoke.py`` takes
its bounds from the same figures. ``analytic_flops`` covers the LM
families the port has (dense, ssm); the others raise, as the port does not
carry them yet (ROADMAP Queue A 11).
"""
from __future__ import annotations

import dataclasses

import numpy as np

PEAK_FLOPS = 989e12       # bf16 dense tensor cores, H100 SXM data sheet
HBM_BW = 3.35e12          # bytes/s, HBM3, H100 SXM data sheet
ICI_BW = 450e9            # bytes/s, NVLink 4 one direction, H100 SXM data sheet
F32_FLOPS = 67e12         # f32 outside the tensor cores, H100 SXM data sheet
TF32_FLOPS = 495e12       # TF32 dense tensor cores, H100 SXM data sheet

__all__ = [
    "RooflineReport",
    "roofline_terms",
    "analytic_flops",
    "count_params",
    "active_param_fraction",
    "PEAK_FLOPS",
    "HBM_BW",
    "ICI_BW",
    "F32_FLOPS",
    "TF32_FLOPS",
]

_PORTED_FAMILIES = ("dense", "ssm")


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    analytic_flops: float
    hlo_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    peak_memory_bytes: float
    collective_by_op: dict
    note: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max-term: 1.0 = perfectly compute-bound."""
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0


def roofline_terms(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    collective_by_op: dict,
    model_flops: float,
    analytic: float,
    peak_memory_bytes: float = 0.0,
    note: str = "",
    peak_flops: float = PEAK_FLOPS,
) -> RooflineReport:
    """The three terms of one rank's traced program (the reference's names:
    ``hlo_flops``/``hlo_bytes`` are the trace's counts here). ``peak_flops``
    is the rate the work's dtype runs at (bf16 tensor cores by default)."""
    flops_per_chip = max(hlo_flops, analytic / chips)
    compute_s = flops_per_chip / peak_flops
    memory_s = hlo_bytes / HBM_BW
    collective_s = collective_bytes / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = (model_flops / chips) / flops_per_chip if flops_per_chip > 0 else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips, hlo_flops=hlo_flops,
        analytic_flops=analytic, hlo_bytes=hlo_bytes, collective_bytes=collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s, dominant=dominant,
        model_flops=model_flops, useful_ratio=useful, peak_memory_bytes=peak_memory_bytes,
        collective_by_op=collective_by_op, note=note,
    )


# ---------------------------------------------------------------------------
# analytic FLOPs (6·N·D convention)
# ---------------------------------------------------------------------------


def count_params(tree) -> int:
    """Elements of a module's parameters, or of every tensor or array in a
    tree (dicts, lists, tuples)."""
    if hasattr(tree, "parameters") and callable(tree.parameters):
        return sum(int(p.numel()) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return int(np.prod(getattr(tree, "shape", ())))


def _check_family(cfg) -> None:
    if cfg.family not in _PORTED_FAMILIES:
        raise NotImplementedError(
            f"analytic FLOPs of the {cfg.family!r} family: the port carries dense and ssm "
            "models only (ROADMAP Queue A 11)")


def active_param_fraction(cfg) -> float:
    """The share of parameters a token uses: 1 for the families the port
    has (MoE's top_k / n_experts waits for the MoE port)."""
    _check_family(cfg)
    return 1.0


def analytic_flops(cfg, n_params: int, shape, kind: str) -> tuple[float, float]:
    """(analytic_total, model_flops = 6·N_active·D) of a global step, the
    reference's convention: ``shape`` carries ``global_batch`` and
    ``seq_len``; ``kind`` is train, prefill or decode. analytic_total adds
    the quadratic attention term of a dense model."""
    _check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    embed_params = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_body = max(n_params - embed_params, 1)
    n_active = n_body * active_param_fraction(cfg) + cfg.d_model * cfg.vocab_size  # logits
    if kind == "train":
        tokens, passes = B * S, 6.0  # fwd 2 + bwd 4
    elif kind == "prefill":
        tokens, passes = B * S, 2.0
    else:  # decode: one token per sequence
        tokens, passes = B * 1, 2.0
    base = passes * n_active * tokens
    attn = 0.0
    if cfg.family == "dense":  # decode reads S keys for 1 query
        attn = passes * 2 * cfg.n_layers * tokens * S * cfg.n_heads * cfg.head_dim
    return base + attn, passes * n_active * tokens
