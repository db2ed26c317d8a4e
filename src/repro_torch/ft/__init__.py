"""Fault tolerance for the coreset pipeline: supervision, elastic
re-meshing, failure injection — the port of ``repro.ft``, the same exports.

Three cooperating pieces (each module carries its full contract):

* ``ft.config`` — the single Alpa-style knob surface (``FTConfig``
  singleton): retry budget/backoff, non-finite rollback + LR backoff,
  sweep-checkpoint cadence, straggler deadlines, KV timeouts, and the
  installed ``FailureSimulator``. Override via ``ft_overrides(...)`` or
  ``REPRO_FT_*`` env vars; ``maybe_inject(phase, step)`` is the injection
  hook the pipeline calls at its phase boundaries (scoring segment saved,
  fit step started, checkpoint tmp built).
* ``ft.failure`` — decision logic + errors: ``ElasticPlanner.plan(n_alive)``
  picks the degraded mesh with batch/LR rescaled, ``StragglerPolicy`` drives
  backup data draws, ``FailureSimulator`` injects ``InjectedFailure`` at
  (phase, step) points with a persistent log, ``NonFiniteError`` carries a
  detected divergence.
* ``ft.supervisor`` — ``RunSupervisor.run(attempt_fn)``: bounded retry with
  exponential backoff around an attempt closure that rebuilds its compute
  from a ``RunContext`` (``resume`` → restore last atomic checkpoint,
  ``mesh``/``plan`` → re-shard onto survivors, ``lr_scale`` → backed-off
  optimizer via ``optim.scale_updates``).

Wired in: ``train/loop.py`` (non-finite detection before checkpointing),
``core/mctm_fit.py`` (the adam and lbfgs fits supervised),
``core/scoring.py`` (resumable sweeps via ``score(sweep_ckpt=, resume=)``),
``core/streaming.py`` (per-window checkpoints, ``resume()``),
``checkpoint/manager.py`` (torn-write injection point),
``launch/train_mctm.py --inject-failures`` (end-to-end drill).
"""
from repro_torch.ft.config import FTConfig, ft_overrides, get_ft_config, maybe_inject
from repro_torch.ft.failure import (
    ElasticPlanner,
    FailureSimulator,
    InjectedFailure,
    MeshPlan,
    NonFiniteError,
    StragglerPolicy,
)
from repro_torch.ft.supervisor import RunContext, RunSupervisor, mesh_from_plan

__all__ = [
    "ElasticPlanner",
    "FailureSimulator",
    "InjectedFailure",
    "MeshPlan",
    "NonFiniteError",
    "StragglerPolicy",
    "FTConfig",
    "get_ft_config",
    "ft_overrides",
    "maybe_inject",
    "RunContext",
    "RunSupervisor",
    "mesh_from_plan",
]
