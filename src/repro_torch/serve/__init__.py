"""Serving of the port's decoder LMs (``serve.engine``) and of fitted MCTM
densities (``serve.density``)."""
from repro_torch.serve.density import DensityRequest, DensityServeEngine
from repro_torch.serve.engine import GenerationConfig, Request, ServeEngine

__all__ = ["GenerationConfig", "Request", "ServeEngine", "DensityRequest", "DensityServeEngine"]
