"""Deliberately broken programs that the port's analysis gate MUST fail on.

The torch forms of the reference's five fixtures
(``repro.analysis.violations``): each seeds exactly one bug of a class the
checks exist to catch, against the honest budget a reviewer would have
written for the correct program. They stay out of the registry
(``all_programs()`` stays clean) and are reached through
``scripts/torch_analysis_gate.py --seed-violation <name>`` and the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.registry import (
    CollectiveBudget,
    MaterializationBudget,
    ProgramSpec,
)

__all__ = ["VIOLATIONS", "stacked_basis_data"]

_N, _J, _DEGREE, _CHUNK = 1024, 2, 3, 32  # rows, dims, degree (D = 8), chunk rows
_WORLD = 8


def stacked_basis_data() -> np.ndarray:
    """The seeded Y of ``stacked_basis`` (the reference fixture's)."""
    return np.random.default_rng(0).normal(size=(_N, _J)).astype(np.float32)


def _cfg_scaler():
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.mctm import MCTMConfig

    return MCTMConfig(J=_J, degree=_DEGREE), DataScaler.fit(stacked_basis_data())


def _build_extra_psum(dev, mesh):
    y = torch.ones((_N // _WORLD, _J), device=dev)

    def body(y):
        # the bug: a second fold call site where one fold of both sums suffices
        s = mesh.fold([torch.sum(y)])[0]
        ss = mesh.fold([torch.sum(torch.square(y))])[0]
        return s + ss

    return body, (y,)


def _build_stacked_basis(dev, mesh):
    from repro_torch.core.mctm import basis_features

    cfg, scaler = _cfg_scaler()
    # the bug: featurizing ALL n rows at once → an (n, J, d) basis block
    return (lambda y: basis_features(cfg, scaler, y)), (
        torch.as_tensor(stacked_basis_data(), device=dev),)


def _build_f64_promotion(dev, mesh):
    from repro_torch.core.mctm import basis_features

    cfg, scaler = _cfg_scaler()
    Y = torch.as_tensor(stacked_basis_data()[:_CHUNK], device=dev)
    # the bug: a float64 (D,) constant from numpy promotes the f32 features
    scale = torch.from_numpy(np.full(_J * (_DEGREE + 1), 1.5)).to(dev)

    def fn(y):
        A, _ = basis_features(cfg, scaler, y)
        return torch.sum(A.reshape(A.shape[0], -1) * scale)

    return fn, (Y,)


def _build_missing_donation(dev, mesh):
    p = torch.zeros((8, 8), device=dev)

    def step(state):
        (w,) = state
        g = 2.0 * w + 1.0
        # the bug: p = p - lr·g rebinds the state to a new tensor where the
        # step should update it in place (p.sub_(lr·g)), so every step copies
        return (w - 0.1 * g,), {"grad_norm": torch.linalg.vector_norm(g)}

    return step, ((p,),)


def _build_host_callback(dev, mesh):
    from repro_torch.core.mctm import init_params, nll_terms
    from repro_torch.core.mctm_fit import fit_featurize

    cfg, scaler = _cfg_scaler()
    feat = fit_featurize(cfg, scaler)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    Y = torch.as_tensor(stacked_basis_data()[:4 * _CHUNK], device=dev)
    log: list = []

    def sweep(params, Y):
        total = torch.zeros((), device=dev)
        for lo in range(0, Y.shape[0], _CHUNK):
            A, Ap = feat(Y[lo:lo + _CHUNK])
            loss = torch.sum(nll_terms(cfg, params, A, Ap))
            # the bug: a host read for logging inside the chunk loop — every
            # chunk now waits for the device
            log.append(loss.item())
            total = total + loss
        return total

    return sweep, (params, Y)


VIOLATIONS: dict[str, ProgramSpec] = {
    "extra_psum": ProgramSpec(
        name="violation_extra_psum",
        description="a second fold call site against a one-fold budget",
        build=_build_extra_psum,
        collectives=CollectiveBudget(fold=1),
        needs_world=_WORLD,
    ),
    "stacked_basis": ProgramSpec(
        name="violation_stacked_basis",
        description="the full (n, J, d) basis featurized at once against a chunk budget",
        build=_build_stacked_basis,
        materialization=MaterializationBudget(row_elems=_J, fixed_elems=2048),
        kernels=(("bernstein", 1),),
    ),
    "f64_promotion": ProgramSpec(
        name="violation_f64_promotion",
        description="a float64 (D,) numpy constant promotes f32 features",
        build=_build_f64_promotion,
        kernels=(("bernstein", 1),),
    ),
    "missing_donation": ProgramSpec(
        name="violation_missing_donation",
        description="a step that rebinds its state where it should update it in place",
        build=_build_missing_donation,
        inplace_state=1,
    ),
    "host_callback": ProgramSpec(
        name="violation_host_callback",
        description="an .item() for logging inside a sweep's chunk loop",
        build=_build_host_callback,
        kernels=(("bernstein", 4),),
    ),
}
