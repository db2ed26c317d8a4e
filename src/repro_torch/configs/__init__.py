"""Architecture registry of the port: ``get_config(name)`` /
``get_reduced_config(name)``.

Every architecture of the reference lives in its own module with the exact
published numbers (copies of ``repro/configs/<id>.py``); ``reduced()``
shrinks each to CPU-test size (same family and topology, tiny widths).
Random init only: no weights are downloaded.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_NAMES = ("phi3_vision_4b", "olmo_1b", "minicpm3_4b", "tinyllama_1b", "gemma_2b",
              "arctic_480b", "qwen2_moe_a2_7b", "whisper_medium", "mamba2_370m",
              "recurrentgemma_2b")

# public ids → module names, the reference's full list
ARCH_IDS = {
    "phi-3-vision-4.2b": "phi3_vision_4b",
    "olmo-1b": "olmo_1b",
    "minicpm3-4b": "minicpm3_4b",
    "tinyllama-1.1b": "tinyllama_1b",
    "gemma-2b": "gemma_2b",
    "arctic-480b": "arctic_480b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "whisper-medium": "whisper_medium",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def _module(name: str):
    mod_name = ARCH_IDS.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_NAMES:
        raise ValueError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced_config(name: str) -> ModelConfig:
    return _module(name).reduced()


def all_configs() -> dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
