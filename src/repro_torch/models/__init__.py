"""Decoder LMs of the port: configs, layers, the dense and SSM families."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import model_from_jax
from repro_torch.models.transformer import Model, build_model

__all__ = ["Model", "ModelConfig", "build_model", "model_from_jax"]
