"""Architecture registry: name -> ModelConfig, for the configs ported."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "yi-9b": "yi_9b",
    "llama3-8b": "llama3_8b",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
