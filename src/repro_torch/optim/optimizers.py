"""AdamW exactly as ``repro.optim.optimizers.adamw`` writes it, and
``scale_updates`` (the supervisor's LR backoff) — the port of the part of
``repro.optim`` the MCTM fit runs.

The update is u = −lr_t · (m/bc1) / (√(v/bc2) + eps): eps sits outside the
square root of the bias-corrected second moment, and the defaults are
b2 = 0.95, which is why ``torch.optim.Adam`` is not a substitute. Parameters,
gradients and states are lists of tensors; the schedule takes the integer
step and returns a float32 scalar.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["Optimizer", "adamw", "apply_updates", "scale_updates"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # update(grads, state, params, step) -> (updates, new_state)


def _as_schedule(lr) -> Callable[[int], np.float32]:
    return lr if callable(lr) else (lambda step: np.float32(lr))


def apply_updates(params: list[torch.Tensor], updates: list[torch.Tensor]) -> None:
    """p ← p + u, in place (the parameters are leaves of the autograd graph)."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return {"m": zeros, "v": [torch.zeros_like(z) for z in zeros]}

    def update(grads, state, params, step: int):
        gf = [g.float() for g in grads]
        m = [b1 * m_ + (1 - b1) * g for m_, g in zip(state["m"], gf)]
        v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(state["v"], gf)]
        # scalar algebra in float32, as the reference traces it; handed to
        # torch as Python floats (exact for float32 values)
        t = np.float32(step) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        lr_t = float(sched(step))

        def upd(m_, v_, p):
            u = -lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.detach().float()
            return u

        return [upd(m_, v_, p) for m_, v_, p in zip(m, v, params)], {"m": m, "v": v}

    return Optimizer(init, update)


def scale_updates(optimizer: Optimizer, scale: float) -> Optimizer:
    """Multiply emitted updates by ``scale``: LR backoff that leaves the
    optimizer state's structure untouched, so checkpoints written before the
    backoff still restore (the supervisor's non-finite rollback)."""
    if scale == 1.0:
        return optimizer
    s = float(scale)

    def update(grads, state, params, step):
        updates, new_state = optimizer.update(grads, state, params, step)
        return [u * s for u in updates], new_state

    return Optimizer(optimizer.init, update)
