"""Architecture registry: name -> ModelConfig, and the abstract inputs of
every (architecture x input shape) pair.

``input_specs(cfg, shape)`` and ``cache_specs(cfg, batch, max_seq)`` give
``TensorSpec(shape, dtype)`` records for every model input and cache
leaf of the given shape, allocating nothing (reference
``configs/registry.py:42-130``, whose records are
``jax.ShapeDtypeStruct``s).
"""

from __future__ import annotations

import importlib
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.models.config import InputShape, ModelConfig

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


class TensorSpec(NamedTuple):
    """The shape and dtype of a tensor that is not allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in _MODULES}


# ------------------------------------------------------------- cache shapes
def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                dtype: str = "bfloat16") -> dict:
    """Spec tree mirroring the transformer's dense cache structure."""
    dt = getattr(torch, dtype)
    kvh, dh, nb = cfg.n_kv_heads, cfg.head_dim_, cfg.n_blocks
    out = {}
    for i, spec in enumerate(cfg.pattern):
        c = {}
        if spec.mixer == "attn":
            kv = TensorSpec((nb, batch, max_seq, kvh, dh), dt)
            c["self"] = {"k": kv, "v": kv}
        else:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            H = d_in // s.head_dim
            ch = d_in + 2 * s.ngroups * s.d_state
            c["self"] = {
                "conv": TensorSpec((nb, batch, s.d_conv - 1, ch), dt),
                "ssm": TensorSpec((nb, batch, H, s.head_dim, s.d_state),
                                  torch.float32)}
        if spec.cross_attn:
            kv = TensorSpec((nb, batch, cfg.cross_kv_len, kvh, dh), dt)
            c["cross"] = {"k": kv, "v": kv}
        out[str(i)] = c
    return out


def _pos_spec(cfg: ModelConfig, batch: int, seq: int) -> TensorSpec:
    shape = (3, batch, seq) if cfg.rope_type == "mrope" else (batch, seq)
    return TensorSpec(shape, torch.int32)


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype: str = "bfloat16") -> dict:
    """Inputs of the step of the given shape kind."""
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, getattr(torch, dtype)
    if shape.kind == "train":
        d: dict = {}
        s_tok = S
        if cfg.encoder_decoder:
            # the stubbed audio frontend's frame embeddings; the decoder's
            # token stream at S // 4 (at least 64)
            s_tok = max(S // 4, 64)
            d["encoder_frames"] = TensorSpec((B, S, cfg.d_model), dt)
        d["tokens"] = TensorSpec((B, s_tok), i32)
        d["labels"] = TensorSpec((B, s_tok), i32)
        d["positions"] = _pos_spec(cfg, B, s_tok)
        return d
    if shape.kind == "prefill":
        d = {}
        s_tok = S
        if cfg.encoder_decoder:
            s_tok = 4                                   # decoder prompt
            d["encoder_frames"] = TensorSpec((B, S, cfg.d_model), dt)
        d["tokens"] = TensorSpec((B, s_tok), i32)
        d["positions"] = _pos_spec(cfg, B, s_tok)
        return d
    if shape.kind == "decode":
        return {"tokens": TensorSpec((B, 1), i32),
                "positions": _pos_spec(cfg, B, 1),
                "cache_len": TensorSpec((B,), i32),
                "caches": cache_specs(cfg, B, S, dtype)}
    raise ValueError(shape.kind)


def supports_shape(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k needs a sub-quadratic path; Whisper has no 500k decode."""
    if shape.name == "long_500k":
        return cfg.has_subquadratic_path
    return True
