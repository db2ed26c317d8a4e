"""Shared step-loop and checkpoint-resume mechanics — the port of
``repro.train.loop``.

Every mode of the MCTM fit layer (``core.mctm_fit``: the adam ``TrainState``
steps and the L-BFGS driver with its ``LBFGSState``) drives the same loop:
step → collect loss → periodic log → periodic checkpoint → final checkpoint,
with restart-after-failure resuming from the latest restorable step. The
state is any tree (``checkpoint.manager``) carrying a ``step`` field;
``batch_fn(i)`` returns the step's batch.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.ft.config import get_ft_config, maybe_inject
from repro_torch.ft.failure import NonFiniteError

__all__ = ["restore_train_state", "train_loop"]


def restore_train_state(mgr, state):
    """Restore the latest checkpoint into ``state``'s structure, each leaf
    on its template leaf's device and dtype. No-op (returns ``(state, 0)``)
    when ``mgr`` is None or holds no steps."""
    if mgr is None or mgr.latest_step() is None:
        return state, 0
    state = mgr.restore(state)
    return state, int(state.step)


def _finite_pair(metrics) -> tuple[float, float]:
    """(loss, grad_norm) as floats, in one device read when both are
    tensors on one device (the finiteness check's only host sync)."""
    loss, gn = metrics["loss"], metrics.get("grad_norm")
    if isinstance(loss, torch.Tensor) and isinstance(gn, torch.Tensor):
        v = torch.stack([loss.detach().float().reshape(()), gn.detach().float().reshape(())])
        a, b = v.tolist()
        return a, b
    return float(loss), (float(gn) if gn is not None else 0.0)


def train_loop(
    step_fn: Callable,
    state,
    batch_fn: Callable[[int], dict],
    steps: int,
    *,
    start: int = 0,
    mgr=None,
    ckpt_every: int = 0,
    log_every: int = 0,
    label: str = "train",
    keep_losses: bool = True,
):
    """Drive ``step_fn(state, batch_fn(i))`` from ``start`` to ``steps``.

    Returns ``(state, losses)`` with one loss per executed step (tensors
    stay on the device; callers convert once); ``keep_losses=False`` keeps
    only the latest (long runs: one live loss, not one a step). Checkpoints every
    ``ckpt_every`` steps plus a final
    save when ``mgr`` is given and any step ran (skipped when the last
    periodic save already covered ``steps``).

    With the ``ft`` config's ``nonfinite_rollback`` (default), a non-finite
    loss or grad norm raises ``NonFiniteError`` at the
    ``nonfinite_check_every`` cadence, *before* the poisoned state can be
    checkpointed: the supervisor backs off the LR and resumes from the last
    good checkpoint.
    """
    ft = get_ft_config()
    losses = []
    t0 = time.time()
    last_saved = None
    for i in range(start, steps):
        maybe_inject("fit", i)
        state, metrics = step_fn(state, batch_fn(i))
        if ft.nonfinite_rollback and (i + 1) % max(ft.nonfinite_check_every, 1) == 0:
            loss_v, gn_v = _finite_pair(metrics)
            if not (np.isfinite(loss_v) and np.isfinite(gn_v)):
                raise NonFiniteError(i, loss=loss_v, grad_norm=gn_v)
        if keep_losses:
            losses.append(metrics["loss"])
        else:
            losses = [metrics["loss"]]
        if log_every and (i + 1) % log_every == 0:
            print(
                f"[{label}] step {i + 1:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({(time.time() - t0) / (i - start + 1):.3f}s/step)",
                flush=True,
            )
        if mgr is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            mgr.save(i + 1, state)
            last_saved = i + 1
    if mgr is not None and steps > start and last_saved != steps:
        mgr.save(steps, state)
    return state, losses
