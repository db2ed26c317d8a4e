"""Program registry of the port's invariant auditor.

A :class:`ProgramSpec` names one hot path of the port, a ``build(device,
mesh)`` that reconstructs it on small shapes as its production call site
does, and the declarative budgets the checks in
:mod:`repro_torch.analysis.checks` enforce over one call of it. The fields
are the reference's (``repro.analysis.registry``) where torch measures the
same thing, and say what torch can measure where it does not: the
collectives are ``DataMesh.census`` calls by kind, not HLO ops; the
donation audit is the storage the state's leaves keep; host round-trips are
counted reads. Registration is data: the port's programs live in
:mod:`repro_torch.analysis.programs`, the deliberately broken ones in
:mod:`repro_torch.analysis.violations`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = [
    "CollectiveBudget",
    "MaterializationBudget",
    "ProgramSpec",
    "register",
    "get_program",
    "all_programs",
]

# the census kinds of ``DataMesh`` (``distributed/mesh.py``)
CENSUS_KINDS = ("fold", "hull_gather", "row_gather", "kv_gather", "kv_allreduce", "kv_barrier")


@dataclasses.dataclass(frozen=True)
class CollectiveBudget:
    """Expected ``DataMesh.census`` of one call, calls by kind.

    ``fold`` is the port's ``psum`` (one packed ``all_gather``, summed in
    rank order), ``hull_gather`` the extremes' gather pair, ``row_gather``
    rows gathered at the end, ``kv_*`` the host exchange. ``exact=True``
    pins every kind; ``exact=False`` gates on a ceiling (a refactor may
    remove a collective silently, never add one), as in the reference."""

    fold: int = 0
    hull_gather: int = 0
    row_gather: int = 0
    kv_gather: int = 0
    kv_allreduce: int = 0
    kv_barrier: int = 0
    exact: bool = True

    def as_dict(self) -> dict[str, int]:
        return {k: getattr(self, k) for k in CENSUS_KINDS}


@dataclasses.dataclass(frozen=True)
class MaterializationBudget:
    """The reference's bound proving "never materialize an (n, J, d)
    basis": every op's output is either row-like (``size / max(shape) ≤
    row_elems``) or chunk-bounded (``size ≤ fixed_elems``)."""

    row_elems: int
    fixed_elems: int


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One registered hot path and its declared invariants.

    ``build(device, mesh)`` → ``(fn, args)``: the auditor calls
    ``fn(*args)`` once (on the CPU under fake tensors, never executed; on
    the card for real, after one unaudited warm-up call). ``mesh`` is rank
    0's ``DataMesh`` on a fake world of ``needs_world`` ranks (None at 1).

    ``inplace_state``: the number of state leaves (``args[0]``, returned as
    the output's first item) whose storage the call reuses — the port's
    DONATE-STATE; None skips the audit. ``host_reads``: the exact number of
    device-to-host reads (a read on the CPU, a synchronizing call on the
    card); 0 where HOST-FREE binds, and each declared one has its reason in
    ``docs/TORCH_INVARIANTS.md``. ``kernels``: the launches a call must make,
    by kernel (the wrappers' ``LAUNCHES``; on the CPU their plain
    versions' dispatches) — SWEEP-FUSED's census."""

    name: str
    description: str
    build: Callable[[Any, Any], tuple[Any, tuple]]
    collectives: CollectiveBudget = CollectiveBudget()
    materialization: MaterializationBudget | None = None
    allow_f64: bool = False
    inplace_state: int | None = None
    host_reads: int = 0
    kernels: tuple[tuple[str, int], ...] = ()
    needs_world: int = 1
    # invariant ids (the reference's, docs/INVARIANTS.md) this program is bound by
    invariants: tuple[str, ...] = ()


_REGISTRY: dict[str, ProgramSpec] = {}


def register(spec: ProgramSpec) -> ProgramSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate program spec {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_loaded() -> None:
    # registration by import; deferred so `import repro_torch.analysis` stays light
    from repro_torch.analysis import programs  # noqa: F401


def get_program(name: str) -> ProgramSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"no program spec {name!r} (known: {known})")
    return _REGISTRY[name]


def all_programs() -> list[ProgramSpec]:
    _ensure_loaded()
    return list(_REGISTRY.values())
