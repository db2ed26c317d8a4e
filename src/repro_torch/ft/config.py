"""Global fault-tolerance configuration (Alpa-style module singleton) — the
port of ``repro.ft.config``, the same fields and defaults. It is the port's
own singleton: setting the reference's does not set this one.

All of the supervisor/retry/deadline knobs live in one mutable dataclass
singleton that the pipeline layers read at use time:

  * ``train/loop.py``   — non-finite guard cadence, fit-phase injection
  * ``checkpoint/``     — checkpoint-phase injection
  * ``core/scoring.py`` — sweep checkpoint cadence, scoring-phase injection
  * ``core/streaming.py`` — streaming-phase injection
  * ``ft/supervisor.py`` — retry budget, backoff schedule, LR backoff

The straggler, KV-timeout and device-count fields are carried for the
modules that read them in the reference (the minibatch loader, the
multi-process engine: ROADMAP Queue A 1, 8 and 9).

Environment overrides: any scalar field can be set via
``REPRO_FT_<FIELDNAME>`` (upper-case), e.g. ``REPRO_FT_MAX_RETRIES=5``.

Tests mutate the singleton through the ``ft_overrides(...)`` context
manager, which restores the previous values on exit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

from repro_torch.ft.failure import FailureSimulator

__all__ = ["FTConfig", "get_ft_config", "ft_overrides", "maybe_inject"]


@dataclasses.dataclass
class FTConfig:
    # -- supervisor retry/backoff
    max_retries: int = 3                 # retries after the first attempt
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0
    # -- graceful degradation in the fit
    nonfinite_rollback: bool = True      # raise NonFiniteError instead of corrupting the run
    nonfinite_check_every: int = 1       # steps between host-side finiteness checks
    lr_backoff_factor: float = 0.5       # LR scale applied per non-finite rollback
    rescale_lr: bool = True              # apply MeshPlan.lr_scale after a re-plan
    # -- resumable scoring sweeps
    sweep_ckpt_every_chunks: int = 4     # chunk-scan state saved every N chunks
    # -- straggler mitigation (minibatch loader); 0 disables
    straggler_deadline_ms: float = 0.0
    straggler_backup_factor: int = 2
    # -- multi-process coordination
    kv_timeout_ms: int = 120_000         # KV-store barrier/get deadline
    min_devices: int = 1
    # -- failure injection (None in production)
    simulator: FailureSimulator | None = None

    def backoff_s(self, attempt: int) -> float:
        """Exponential backoff delay before retry ``attempt`` (0-based)."""
        return min(self.backoff_base_s * self.backoff_factor**attempt, self.backoff_max_s)


def _env_overrides(cfg: FTConfig) -> FTConfig:
    for f in dataclasses.fields(cfg):
        raw = os.environ.get(f"REPRO_FT_{f.name.upper()}")
        if raw is None:
            continue
        if f.type in ("int", int):
            setattr(cfg, f.name, int(raw))
        elif f.type in ("float", float):
            setattr(cfg, f.name, float(raw))
        elif f.type in ("bool", bool):
            setattr(cfg, f.name, raw.lower() in ("1", "true", "yes", "on"))
    return cfg


ft_config = _env_overrides(FTConfig())


def get_ft_config() -> FTConfig:
    """The process-wide fault-tolerance configuration singleton."""
    return ft_config


def maybe_inject(phase: str, step: int) -> None:
    """Injection point: no-op unless a ``FailureSimulator`` is installed.

    Every failure-prone phase calls this with its own phase tag
    ("scoring" per chunk, "fit" per step, "checkpoint" per save) so
    ``--inject-failures`` runs can target each phase independently.
    """
    sim = ft_config.simulator
    if sim is not None:
        sim.maybe_fail(step, phase=phase)


_FIELDS = {f.name for f in dataclasses.fields(FTConfig)}


@contextlib.contextmanager
def ft_overrides(**kwargs):
    """Temporarily override singleton fields (tests / scoped injection)."""
    unknown = set(kwargs) - _FIELDS
    if unknown:
        raise TypeError(f"unknown FTConfig fields: {sorted(unknown)}")
    old = {k: getattr(ft_config, k) for k in kwargs}
    for k, v in kwargs.items():
        setattr(ft_config, k, v)
    try:
        yield ft_config
    finally:
        for k, v in old.items():
            setattr(ft_config, k, v)
