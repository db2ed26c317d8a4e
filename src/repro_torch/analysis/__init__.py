"""The invariant auditor of the port's hot paths — the counterpart of
``repro.analysis``.

The reference proves its scaling contracts statically, against the lowered
programs: one fused psum a sweep, zero collectives in the segmented resume
sweeps, never an (n, J, d) basis, no f32 → f64 promotion, donated state
really aliased, no host callbacks. The port has no lowering, so it proves
the same contracts by running each hot path once under watch:

* :mod:`repro_torch.analysis.registry` — ``ProgramSpec``: one hot path and
  its budgets (``DataMesh.census`` by kind, the materialization bound, the
  state leaves a step updates in place, declared host reads, the kernel
  launches a call makes).
* :mod:`repro_torch.analysis.programs` — the registered hot paths (fit
  steps, streamed evaluators, the sharded sweeps of
  ``DistributedScoringEngine``, their resumable segments, serving, the
  kernel wrappers), a counterpart of each of the reference's 19.
* :mod:`repro_torch.analysis.checks` — ``audit_program(spec, device=None)``:
  on the CPU under fake tensors (traced, never executed), on the card for
  real; sharded programs as rank 0 of an in-process fake world.
* :mod:`repro_torch.analysis.ast_lints` — the port's copy of the reference's
  Python-level lints (AL001–AL003).
* :mod:`repro_torch.analysis.violations` — deliberately broken programs the
  gate must fail on.

The gate is ``scripts/torch_analysis_gate.py``; the catalogue, each
reference invariant beside its torch check and budget, is
``docs/TORCH_INVARIANTS.md``.
"""
from repro_torch.analysis.checks import audit_program
from repro_torch.analysis.registry import (
    CollectiveBudget,
    MaterializationBudget,
    ProgramSpec,
    all_programs,
    get_program,
    register,
)

__all__ = [
    "CollectiveBudget",
    "MaterializationBudget",
    "ProgramSpec",
    "all_programs",
    "audit_program",
    "get_program",
    "register",
]
