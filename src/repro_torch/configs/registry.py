"""Architecture registry: name -> ModelConfig, for the configs ported."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "yi-9b": "yi_9b",
    "llama3-8b": "llama3_8b",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
