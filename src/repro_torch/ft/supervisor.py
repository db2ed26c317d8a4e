"""RunSupervisor: bounded-retry orchestration around the pipeline loops —
the single-host port of ``repro.ft.supervisor``.

The supervisor wraps an *attempt closure* — a function that (re)builds its
compute from a ``RunContext`` and runs it to completion. Contract:

  * **What is retried.** Any ``RuntimeError`` raised by the attempt — that
    family covers ``InjectedFailure``, ``NonFiniteError`` and CUDA runtime
    errors raised by torch. ``ValueError``/``TypeError``/``KeyboardInterrupt``
    and friends are programming or user errors and propagate immediately, as
    do ``NotImplementedError``/``RecursionError`` and the port's
    ``KernelError`` (a kernel that does not build or launch is a fault of
    the program, never transient: no retry may hide it).
  * **What triggers re-planning.** With a planner attached, every retry
    consults ``ElasticPlanner.plan(n_alive)`` with the visible device count
    and rebuilds the mesh (``mesh_from_plan``, or a caller ``remesh`` hook),
    batch/LR rescaled per the plan. A ``NonFiniteError`` retry applies
    multiplicative LR backoff instead and does not re-plan.
  * **Recovery guarantees.** The attempt closure resumes from the last
    atomic checkpoint when ``ctx.resume`` is set. After ``max_retries``
    failed retries the supervisor aborts with one diagnostic
    ``RuntimeError`` carrying the attempt history and, when a
    ``FailureSimulator`` is installed, its injection log.

The mesh is the caller's: a ``repro_torch.distributed.DataMesh`` (a process
group, one rank per device), which a ``remesh`` hook rebuilds for the new
plan, or, without one, the plan's devices of this host in the plan's shape
(``mesh_from_plan``). Every rank of a mesh runs its own supervisor; the
injected faults, non-finite steps and checkpoints they recover from are
deterministic, so the ranks retry in step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.ft.config import FTConfig, get_ft_config
from repro_torch.ft.failure import ElasticPlanner, MeshPlan, NonFiniteError
from repro_torch.kernels._lib import KernelError

__all__ = ["RunContext", "RunSupervisor", "mesh_from_plan"]

# RuntimeError subclasses that are never transient infrastructure faults
_NON_RETRYABLE = (NotImplementedError, RecursionError, KernelError)


def _visible_devices() -> list[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def mesh_from_plan(plan: MeshPlan, devices=None) -> np.ndarray:
    """The first ``plan.n_devices`` devices in the plan's shape."""
    devs = list(devices) if devices is not None else _visible_devices()
    if plan.n_devices > len(devs):
        raise RuntimeError(f"plan needs {plan.n_devices} devices, only {len(devs)} visible")
    mesh = np.empty(plan.n_devices, dtype=object)
    mesh[:] = devs[: plan.n_devices]
    return mesh.reshape(plan.shape)


@dataclasses.dataclass
class RunContext:
    """What an attempt closure needs to (re)build its compute."""

    attempt: int = 0
    resume: bool = False         # True on every retry: restore from last checkpoint
    mesh: object = None          # current (possibly degraded) mesh, or None
    plan: Optional[MeshPlan] = None
    lr_scale: float = 1.0        # combined non-finite backoff × plan rescale
    batch_scale: float = 1.0     # plan.global_batch / base batch


class RunSupervisor:
    """Bounded retry + exponential backoff + elastic re-planning."""

    def __init__(
        self,
        *,
        label: str = "run",
        planner: Optional[ElasticPlanner] = None,
        mesh=None,
        devices_fn: Optional[Callable[[], int]] = None,
        remesh: Optional[Callable[[MeshPlan], object]] = None,
        config: Optional[FTConfig] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.label = label
        self.planner = planner
        self.mesh = mesh
        self.devices_fn = devices_fn
        self.remesh = remesh
        self.config = config
        self.sleep = sleep
        self.events: list[dict] = []

    @staticmethod
    def _retryable(exc: BaseException) -> bool:
        return isinstance(exc, RuntimeError) and not isinstance(exc, _NON_RETRYABLE)

    def _n_alive(self) -> int:
        if self.devices_fn is not None:
            return int(self.devices_fn())
        return torch.cuda.device_count() if torch.cuda.is_available() else 1

    def _diagnostic(self, cfg: FTConfig, last: BaseException) -> str:
        lines = [
            f"[{self.label}] retry budget exhausted after "
            f"{cfg.max_retries + 1} attempts: {type(last).__name__}: {last}",
            f"attempt history: {self.events}",
        ]
        if cfg.simulator is not None and cfg.simulator.log:
            lines.append(f"injection log: {cfg.simulator.log}")
        return "\n".join(lines)

    def run(self, attempt_fn: Callable[[RunContext], object]):
        """Run ``attempt_fn(ctx)`` to completion, retrying on RuntimeError."""
        cfg = self.config if self.config is not None else get_ft_config()
        ctx = RunContext(mesh=self.mesh)
        nf_scale = 1.0
        for attempt in range(cfg.max_retries + 1):
            ctx.attempt = attempt
            try:
                return attempt_fn(ctx)
            except Exception as exc:  # noqa: BLE001 — filtered below
                if not self._retryable(exc):
                    raise
                self.events.append(
                    {
                        "attempt": attempt,
                        "error": f"{type(exc).__name__}: {exc}",
                        "kind": "nonfinite" if isinstance(exc, NonFiniteError) else "failure",
                    }
                )
                if attempt >= cfg.max_retries:
                    raise RuntimeError(self._diagnostic(cfg, exc)) from exc
                delay = cfg.backoff_s(attempt)
                if delay > 0:
                    self.sleep(delay)
                plan_scale = 1.0
                if isinstance(exc, NonFiniteError):
                    nf_scale *= cfg.lr_backoff_factor
                    if ctx.plan is not None and cfg.rescale_lr:
                        plan_scale = ctx.plan.lr_scale
                elif self.planner is not None:
                    plan = self.planner.plan(self._n_alive())
                    ctx.plan = plan
                    ctx.mesh = self.remesh(plan) if self.remesh else mesh_from_plan(plan)
                    ctx.batch_scale = plan.global_batch / max(self.planner.base_global_batch, 1)
                    if cfg.rescale_lr:
                        plan_scale = plan.lr_scale
                    self.events[-1]["plan"] = {
                        "shape": plan.shape,
                        "axes": plan.axes,
                        "global_batch": plan.global_batch,
                        "lr_scale": plan.lr_scale,
                    }
                elif ctx.plan is not None and cfg.rescale_lr:
                    plan_scale = ctx.plan.lr_scale
                ctx.lr_scale = nf_scale * plan_scale
                ctx.resume = True
        raise AssertionError("unreachable")
