"""Parameter shapes, seeded initialisation, and the bridge from the
reference's parameter tree.

The tree mirrors the reference: ``{"embed", "final_norm", "unembed",
"blocks": {pattern position: {name: (n_blocks, ...)}}}`` with each pattern
position's parameters stacked over a leading ``n_blocks`` axis.  Matrices
are stored in ``cfg.dtype`` (the reference keeps fp32 and casts at every
call; casting once at load gives the same numbers) and norm scales in fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.sharding import resolve_device


def _attn_shapes(cfg: ModelConfig) -> dict:
    d, dh = cfg.d_model, cfg.head_dim_
    hp, kv = cfg.padded_heads, cfg.n_kv_heads
    s = {"wq": (d, hp * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
         "wo": (hp * dh, d)}
    if cfg.qkv_bias:
        s.update({"bq": (hp * dh,), "bk": (kv * dh,), "bv": (kv * dh,)})
    return s


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> dict:
    if spec.mixer != "attn" or spec.cross_attn or spec.ffn == "moe":
        raise NotImplementedError(
            f"{cfg.name}: only dense attention layers are ported so far")
    d = cfg.d_model
    s = {"norm1": (d,)}
    s.update(_attn_shapes(cfg))
    if spec.ffn != "none":
        s["norm2"] = (d,)
        ffn = {"wi": (d, cfg.d_ff), "wo": (cfg.d_ff, d)}
        if cfg.mlp_type == "swiglu":
            ffn["wg"] = (d, cfg.d_ff)
        s["ffn"] = ffn
    return s


def _stack(tree: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in tree.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """Shapes of the dense-decoder parameter tree (reference params.py:80)."""
    if cfg.encoder_decoder or cfg.pos_embedding != "rope":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and learned positions are not "
            "ported yet")
    d = cfg.d_model
    shapes = {"embed": (cfg.padded_vocab, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.padded_vocab, d)
    shapes["blocks"] = {str(i): _stack(_layer_shapes(cfg, spec), cfg.n_blocks)
                        for i, spec in enumerate(cfg.pattern)}
    return shapes


def _is_norm(name: str) -> bool:
    return name.startswith("norm") or name == "final_norm"


def _map_tree(shapes: dict, fn, path=()) -> dict:
    return {k: (_map_tree(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in shapes.items()}


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: Optional[str] = None) -> dict:
    """Seeded initialisation on ``device`` with the reference's rules
    (params.py:188): norms at one, biases at zero, every other tensor
    normal with std ``1/sqrt(fan_in)`` (fan_in = second-to-last dim).
    Torch's generator does not reproduce the reference's numbers; tests
    bridge the reference's tree with ``params_from_numpy`` instead.
    ``device`` defaults to CUDA (raising without a card)."""
    device = resolve_device(device)
    dt = getattr(torch, dtype or cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(path, shape):
        name = path[-1]
        if _is_norm(name):
            return torch.ones(shape, dtype=torch.float32, device=device)
        if name.startswith("b"):
            return torch.zeros(shape, dtype=dt, device=device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.empty(shape, dtype=dt, device=device)
        return w.normal_(0.0, std, generator=gen)

    if cfg.pad_heads_to and cfg.pad_heads_to > cfg.n_heads:
        raise NotImplementedError("padded query heads are not ported yet")
    return _map_tree(param_shapes(cfg), make)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameter tree (numpy arrays, same keys and shapes)
    as the port's on ``device`` (default CUDA): matrices cast once to
    ``cfg.dtype``, norms in fp32."""
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    shapes = param_shapes(cfg)

    def conv(path, shape):
        a = tree
        for k in path:
            a = a[k]
        a = np.array(a, np.float32)          # a writable host copy
        if a.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {a.shape} != {shape}")
        t = torch.from_numpy(a).to(device)
        return t if _is_norm(path[-1]) else t.to(dt)

    return _map_tree(shapes, conv)


def count_params(params: dict) -> int:
    return sum(v.numel() if isinstance(v, torch.Tensor) else count_params(v)
               for v in params.values())
