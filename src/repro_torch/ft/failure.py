"""Fault-tolerance control plane: failure handling + elastic re-meshing —
a copy of ``repro.ft.failure`` in pure numpy.

On a real cluster this layer sits in the coordinator: heartbeats detect dead
hosts, the job drains, and training restarts on the surviving slice from the
last atomic checkpoint. Here we implement the *decision logic* (pure,
testable) plus a single-process failure simulator used by the integration
tests:

  * ``ElasticPlanner.plan(n_alive)`` — pick the largest valid mesh that fits
    the survivors while (a) keeping the model axis intact if possible (TP
    degree is dictated by memory), (b) shrinking data/pod axes first, and
    (c) rescaling batch/LR consistently.
  * ``FailureSimulator`` — drives a train loop, injecting failures at chosen
    (phase, step) points. Every firing is appended to a persistent ``log``
    so a post-mortem (or the retry-budget-exhausted diagnostic) can show the
    full injection history; ``mode="every"`` rules re-fire on each retry,
    which is how crash-loop → clean-abort scenarios are tested.
  * ``StragglerPolicy`` — deadline-based backup-draw decision for the
    minibatch loading path.

The errors raised by the pipeline's failure paths also live here (so that
``train/loop.py`` and ``core/*`` can import them without cycles):
``InjectedFailure`` for simulated faults and ``NonFiniteError`` for a
detected non-finite loss/gradient. Both subclass ``RuntimeError``, the
retryable family that ``ft.supervisor.RunSupervisor`` catches.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "MeshPlan",
    "ElasticPlanner",
    "FailureSimulator",
    "StragglerPolicy",
    "InjectedFailure",
    "NonFiniteError",
]


class InjectedFailure(RuntimeError):
    """A simulated node/step failure raised by ``FailureSimulator``."""


class NonFiniteError(RuntimeError):
    """Non-finite loss or gradient detected during a fit step.

    Carries enough context (``step``, ``loss``, ``grad_norm``) for the
    supervisor to log a useful diagnostic and apply LR backoff before
    resuming from the last checkpoint.
    """

    def __init__(self, step: int, loss=None, grad_norm=None):
        super().__init__(
            f"non-finite training signal at step {step}: "
            f"loss={loss} grad_norm={grad_norm}"
        )
        self.step = int(step)
        self.loss = loss
        self.grad_norm = grad_norm


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    global_batch: int
    lr_scale: float
    devices_used: int

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


@dataclasses.dataclass
class ElasticPlanner:
    """Chooses a degraded mesh after failures (and upsizes when nodes return)."""

    model_parallel: int           # required TP degree (memory-bound, fixed)
    base_data_parallel: int       # DP at full strength (per pod)
    n_pods: int = 1
    base_global_batch: int = 256
    min_data_parallel: int = 1

    def plan(self, n_alive: int) -> MeshPlan:
        if n_alive < self.model_parallel * self.min_data_parallel:
            raise RuntimeError(
                f"{n_alive} devices cannot host model_parallel={self.model_parallel}"
            )
        # keep TP fixed; give the rest to (pod × data), preferring pod-sized blocks
        total_rows = n_alive // self.model_parallel
        pods = min(self.n_pods, total_rows)
        while pods > 1 and total_rows % pods != 0:
            pods -= 1
        data = total_rows // pods
        # batch scales with the surviving DP degree; LR follows linearly
        full_rows = self.base_data_parallel * self.n_pods
        frac = (data * pods) / full_rows
        gbatch = max(int(self.base_global_batch * frac), 1)
        if pods > 1:
            shape = (pods, data, self.model_parallel)
            axes = ("pod", "data", "model")
        else:
            shape = (data, self.model_parallel)
            axes = ("data", "model")
        return MeshPlan(
            shape=shape,
            axes=axes,
            global_batch=gbatch,
            lr_scale=frac,
            devices_used=data * pods * self.model_parallel,
        )


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based straggler mitigation for the data-loading path.

    If a shard's batch is not ready within `deadline_ms`, the step proceeds
    with the backup batch (the deterministic re-sample of the same step with
    a fallback seed), and the slow fetch is cancelled. The decision function
    is pure so schedulers can unit-test it; at 1000+ nodes the same policy
    generalizes to backup *workers*: issue the step to `backup_factor`× hosts
    and take the first completion.
    """

    deadline_ms: float = 250.0
    backup_factor: int = 2

    def decide(self, elapsed_ms: np.ndarray) -> np.ndarray:
        """elapsed_ms: per-shard data-ready latency → bool mask 'use backup'."""
        return np.asarray(elapsed_ms) > self.deadline_ms


class FailureSimulator:
    """Drives step functions with injected failures; used by integration tests.

    Two entry styles:

      * legacy: ``FailureSimulator({5})`` — fail once at step 5, any phase.
      * rules:  ``FailureSimulator().inject("scoring", 2).inject("fit", 40,
        mode="every")`` — phase-scoped rules; ``mode="once"`` fires a single
        time across retries, ``mode="every"`` fires on every pass over the
        step (a crash loop that must exhaust the retry budget).

    ``failures`` keeps the legacy list of fired steps; ``log`` is the
    persistent injection log (one dict per firing, never cleared) that the
    supervisor embeds in its abort diagnostic.
    """

    def __init__(self, fail_at_steps=(), *, phase: str | None = None, mode: str = "once"):
        self.fail_at = set(int(s) for s in fail_at_steps)
        self.failures: list[int] = []
        self.log: list[dict] = []
        self._rules: list[dict] = [
            {"phase": phase, "step": s, "mode": mode, "fired": 0}
            for s in sorted(self.fail_at)
        ]

    def inject(self, phase: str | None, step: int, mode: str = "once") -> "FailureSimulator":
        """Add a rule: fail at ``step`` of ``phase`` (None = any phase)."""
        if mode not in ("once", "every"):
            raise ValueError(f"mode must be 'once' or 'every', got {mode!r}")
        self._rules.append({"phase": phase, "step": int(step), "mode": mode, "fired": 0})
        if phase is None:
            self.fail_at.add(int(step))
        return self

    def maybe_fail(self, step: int, phase: str | None = None):
        step = int(step)
        for rule in self._rules:
            if rule["step"] != step:
                continue
            if rule["phase"] is not None and rule["phase"] != phase:
                continue
            if rule["mode"] == "once" and rule["fired"]:
                continue
            rule["fired"] += 1
            self.failures.append(step)
            if rule["mode"] == "once":
                self.fail_at.discard(step)
            entry = {
                "phase": phase if phase is not None else rule["phase"],
                "step": step,
                "mode": rule["mode"],
                "count": rule["fired"],
            }
            self.log.append(entry)
            where = f" ({entry['phase']})" if entry["phase"] else ""
            raise InjectedFailure(f"injected node failure at step {step}{where}")
