"""Serving of the port's decoder LMs (``repro/serve``)."""
from repro_torch.serve.engine import GenerationConfig, Request, ServeEngine

__all__ = ["GenerationConfig", "Request", "ServeEngine"]
