"""Serving of the port's decoder LMs (``serve.engine``) and of fitted MCTM
densities (``serve.density``)."""
from repro_torch.serve.density import (
    DensityRequest,
    DensityServeEngine,
    ModelSlot,
    bucket_for,
    bucket_sizes,
    make_conditional_sample_fn,
    make_log_density_fn,
    refit_and_publish,
    start_background_refit,
)
from repro_torch.serve.engine import GenerationConfig, Request, ServeEngine

__all__ = [
    "GenerationConfig",
    "Request",
    "ServeEngine",
    "DensityRequest",
    "DensityServeEngine",
    "ModelSlot",
    "bucket_sizes",
    "bucket_for",
    "make_log_density_fn",
    "make_conditional_sample_fn",
    "refit_and_publish",
    "start_background_refit",
]
