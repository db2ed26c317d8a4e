"""The LMs of the port: configs, layers and every family of the reference."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import model_from_jax
from repro_torch.models.transformer import EncDecModel, Model, build_model

__all__ = ["EncDecModel", "Model", "ModelConfig", "build_model", "model_from_jax"]
