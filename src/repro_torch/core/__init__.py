"""The paper's core, ported from ``repro.core``: MCTM models, the fit layer,
the scoring engine and coreset constructions, leverage scores, hull
ε-kernels, the conditional model, streaming maintenance and the
distributed scoring engine (over ``repro_torch.distributed``'s mesh).

Public API:
  - MCTMConfig / init_params / nll / fit_mctm / log_density / sample
  - fit_density_model / fit_mctm_streaming / streamed_nll / coreset_epsilon
  - build_coreset / evaluate_coreset (Algorithm 1 + baselines)
  - leverage scores (exact, sketched, ridge, root), hull ε-kernels
  - ScoringEngine + pass strategies (TwoPassExact / TwoPassSketched /
    OnePassSketched)
  - the conditional MCTM (CMCTMConfig / fit_cmctm / build_conditional_coreset)
  - MergeReduceCoreset / StreamingCoresetMaintainer / DriftDetector (streams)
  - DistributedScoringEngine / distributed_build_coreset (Algorithm 1 on a
    data mesh)

The names resolve on first use (PEP 562): the kernels' plain versions import
``repro_torch.core.bernstein``, so importing every module here eagerly would
be circular.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "bernstein": (
        "DataScaler", "bernstein_deriv_design", "bernstein_design", "monotone_theta",
    ),
    "conditional": (
        "CMCTMConfig", "CMCTMParams", "build_conditional_coreset", "cnll",
        "conditional_coreset_scores", "fit_cmctm",
    ),
    "coreset": (
        "CORESET_METHODS", "CoresetEvaluation", "CoresetResult", "build_coreset",
        "coreset_scores", "evaluate_coreset",
    ),
    "distributed_coreset": (
        "DistributedScoringEngine", "distributed_build_coreset",
    ),
    "hull": (
        "epsilon_kernel_indices", "greedy_hull_projection", "hull_distance",
    ),
    "leverage": (
        "block_B_matrix", "flatten_features", "leverage_scores_gram", "leverage_scores_qr",
        "ridge_leverage_scores", "root_leverage_scores", "sketched_leverage",
    ),
    "mctm": (
        "FitResult", "MCTMConfig", "MCTMParams", "basis_features", "fit_mctm", "init_params",
        "log_density", "nll", "nll_terms", "sample",
    ),
    "mctm_fit": (
        "FIT_METHODS", "coreset_epsilon", "fit_density_model", "fit_mctm_streaming",
        "likelihood_ratio", "streamed_nll",
    ),
    "scoring": (
        "OnePassSketched", "PassStrategy", "ScoringEngine", "ScoringResult", "TwoPassExact",
        "TwoPassSketched", "score_chunks",
    ),
    "sensitivity": (
        "sensitivity_sample",
    ),
    "streaming": (
        "DriftDetector", "MergeReduceCoreset", "StreamingCoresetMaintainer", "WeightedSet",
        "drift_window_nll",
    ),
}
_EXPORTS = {name: mod for mod, names in _MODULES.items() for name in names}
__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
