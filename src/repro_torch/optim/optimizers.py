"""The optimizers of ``repro.optim.optimizers``, each written as the
reference writes it: AdamW, Adafactor (factored second moments), Lion,
SGD (+momentum), global-norm clipping, ``chain`` and ``scale_updates``
(the supervisor's LR backoff).

AdamW's update is u = −lr_t · (m/bc1) / (√(v/bc2) + eps): eps sits outside
the square root of the bias-corrected second moment, and the defaults are
b2 = 0.95, which is why ``torch.optim.Adam`` is not a substitute.
Parameters, gradients and moments are lists of tensors, one entry a
parameter leaf; a state nests as the reference's does (``chain``'s is a
tuple of its transforms' states; a moment is a list where the reference
has a tree of the parameters' structure). The schedule takes the integer
step and returns a float32 scalar; scalar algebra runs in float32 as the
reference traces it and reaches torch as Python floats (exact for float32
values).

``state_specs(pspecs, pshapes)`` gives the logical sharding specs of the
state (``distributed/sharding.py``) from the parameters' spec and shape
trees, in the state's layout: a moment's list holds its leaves' specs in
flatten order. Moments inherit their parameter's axes; Adafactor's factored
``vr`` / ``vc`` drop the last and the second-to-last names.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils.tree import is_spec_leaf, tree_leaves

__all__ = ["Optimizer", "adamw", "adafactor", "lion", "sgd", "chain", "clip_by_global_norm",
           "apply_updates", "scale_updates"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # update(grads, state, params, step) -> (updates, new_state)
    state_specs: Callable | None = None
    # state_specs(param_logical_specs, param_shapes) -> logical specs of the state


def _spec_list(pspecs) -> list:
    """The parameters' specs as a list in flatten order (a moment's layout)."""
    return [tuple(s) for s in tree_leaves(pspecs, is_leaf=is_spec_leaf)]


def _as_schedule(lr) -> Callable[[int], np.float32]:
    return lr if callable(lr) else (lambda step: np.float32(lr))


def _decayed(u: torch.Tensor, lr_t: float, weight_decay: float, p: torch.Tensor) -> torch.Tensor:
    """u − (lr_t·weight_decay)·p, the product of the two scalars in float32."""
    if not weight_decay:
        return u
    return u - float(np.float32(lr_t) * np.float32(weight_decay)) * p.detach().float()


def apply_updates(params: list[torch.Tensor], updates: list[torch.Tensor]) -> None:
    """p ← p + u, in place (the parameters are leaves of the autograd graph)."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))


# ---------------------------------------------------------------------------


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return {"m": zeros, "v": [torch.zeros_like(z) for z in zeros]}

    def update(grads, state, params, step: int):
        gf = [g.float() for g in grads]
        m = [b1 * m_ + (1 - b1) * g for m_, g in zip(state["m"], gf)]
        v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(state["v"], gf)]
        t = np.float32(step) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        lr_t = float(sched(step))

        def upd(m_, v_, p):
            return _decayed(-lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps), lr_t,
                            weight_decay, p)

        return [upd(m_, v_, p) for m_, v_, p in zip(m, v, params)], {"m": m, "v": v}

    def state_specs(pspecs, pshapes):
        return {"m": _spec_list(pspecs), "v": _spec_list(pspecs)}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------


def adafactor(lr, decay=0.8, eps=1e-30, clip_threshold=1.0, weight_decay=0.0) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018): a leaf of two or more axes whose last
    two exceed 1 keeps row and column means of g² (``vr``, ``vc``) in place
    of the full second moment; each leaf's update is clipped to RMS ≤
    ``clip_threshold``."""
    sched = _as_schedule(lr)

    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def init(params):
        def one(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        return [one(p) for p in params]

    def update(grads, state, params, step: int):
        t = np.float32(step) + np.float32(1.0)
        beta = float(np.float32(1.0) - t ** np.float32(-decay))
        lr_t = float(sched(step))

        def one(g, s, p):
            g = g.float()
            g2 = g * g + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                precond = (g * torch.rsqrt(vr[..., None] / denom[..., None])
                           * torch.rsqrt(vc[..., None, :]))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                precond = g * torch.rsqrt(v)
                new_s = {"v": v}
            # update clipping (RMS ≤ clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(precond)) + 1e-30)
            precond = precond / torch.clamp(rms / clip_threshold, min=1.0)
            return _decayed(-lr_t * precond, lr_t, weight_decay, p), new_s

        out = [one(g, s, p) for g, s, p in zip(grads, state, params)]
        return [u for u, _ in out], [s for _, s in out]

    def state_specs(pspecs, pshapes):
        def one(s, p):
            if _factored(tuple(p.shape)):
                return {"vr": s[:-1], "vc": s[:-2] + s[-1:]}
            return {"v": s}

        return [one(s, p) for s, p in zip(_spec_list(pspecs), tree_leaves(pshapes))]

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------


def lion(lr, b1=0.9, b2=0.99, weight_decay=0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    def update(grads, state, params, step: int):
        gf = [g.float() for g in grads]
        lr_t = float(sched(step))
        updates = [_decayed(-lr_t * torch.sign(b1 * m_ + (1 - b1) * g), lr_t, weight_decay, p)
                   for m_, g, p in zip(state["m"], gf, params)]
        m = [b2 * m_ + (1 - b2) * g for m_, g in zip(state["m"], gf)]
        return updates, {"m": m}

    def state_specs(pspecs, pshapes):
        return {"m": _spec_list(pspecs)}

    return Optimizer(init, update, state_specs)


def sgd(lr, momentum=0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    def update(grads, state, params, step: int):
        lr_t = float(sched(step))
        gf = [g.float() for g in grads]
        if momentum == 0.0:
            return [-lr_t * g for g in gf], state
        m = [momentum * m_ + g for m_, g in zip(state["m"], gf)]
        return [-lr_t * m_ for m_ in m], {"m": m}

    def state_specs(pspecs, pshapes):
        return {} if momentum == 0.0 else {"m": _spec_list(pspecs)}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Gradient transformation — compose with ``chain``. The norm and the
    scale stay on the gradients' device (no host read)."""

    def init(params):
        return {}

    def update(grads, state, params, step):
        gf = [g.float() for g in grads]
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in gf))
        scale = torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-12), max=1.0)
        return [g * scale for g in gf], state

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

    return Optimizer(optimizer.init, update, optimizer.state_specs)


def chain(*transforms: Optimizer) -> Optimizer:
    """Compose transformations; each consumes the previous one's updates as
    'gradients'. The last element should be the actual optimizer. The state
    is the tuple of the transforms' states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params, step):
        new_states = []
        cur = grads
        for t, s in zip(transforms, state):
            cur, ns = t.update(cur, s, params, step)
            new_states.append(ns)
        return cur, tuple(new_states)

    def state_specs(pspecs, pshapes):
        return tuple(t.state_specs(pspecs, pshapes) if t.state_specs is not None else {}
                     for t in transforms)

    return Optimizer(init, update, state_specs)
