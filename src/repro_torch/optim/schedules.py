"""Learning-rate schedules — the port of ``repro.optim.schedules``: each
takes the integer step and returns a float32 scalar, computed in float32
in the reference's order of operations."""
from __future__ import annotations

import numpy as np

__all__ = ["constant", "linear_warmup", "cosine_warmup"]

_f32 = np.float32


def constant(lr: float):
    return lambda step: _f32(lr)


def linear_warmup(lr: float, warmup: int):
    def fn(step):
        frac = np.minimum(_f32(step) / _f32(max(warmup, 1)), _f32(1.0))
        return _f32(lr) * frac

    return fn


def cosine_warmup(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = np.minimum(step / _f32(max(warmup, 1)), _f32(1.0))
        prog = np.clip((step - _f32(warmup)) / _f32(max(total - warmup, 1)), _f32(0.0), _f32(1.0))
        # (1 - final_frac) * 0.5 is a Python float before it meets the cosine
        cos = _f32(final_frac) + _f32((1 - final_frac) * 0.5) * (
            _f32(1.0) + np.cos(_f32(np.pi) * prog))
        return _f32(lr) * warm * cos

    return fn
