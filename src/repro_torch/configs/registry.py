"""Architecture registry: name -> ModelConfig, for the configs ported."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "yi-9b": "yi_9b",
    "llama3-8b": "llama3_8b",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "chatglm3-6b": "chatglm3_6b",
    "nemotron-4-15b": "nemotron_4_15b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "llama3-70b": "llama3_70b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mixtral-8x22b": "mixtral_8x22b",
    "whisper-medium": "whisper_medium",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}
NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
