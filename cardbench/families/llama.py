"""A Llama-architecture configuration (RMSNorm, RoPE, GQA, SwiGLU) on the
port's side: the port's ``ModelConfig`` from the configuration file, and
the seeded weights in the port's parameter layout.  The plain reference
of the same architecture is ``cardbench/refs/llama.py``."""

from __future__ import annotations

import math

import torch

REF = "llama"


def port_config(c: dict, dtype: str = "bfloat16"):
    """The port's ModelConfig of the file ``c`` (its own key names)."""
    from repro_torch.models.config import ModelConfig
    if c.get("hidden_act", "silu") != "silu" or c.get("attention_bias"):
        raise ValueError(f"{c['name']}: only SwiGLU without q/k/v bias")
    return ModelConfig(
        name=c["name"], family="dense",
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim", 0),
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        mlp_type="swiglu", rope_type="standard",
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=bool(c.get("tie_word_embeddings", False)),
        dtype=dtype, source=c["source"])


def layout(c: dict) -> dict:
    """The weight tree's shapes, in the port's layout: ``embed`` and
    ``unembed`` (vocabulary rounded up to 256 rows) and one stacked block
    {name: (layers, ...)}; ``wq`` etc. map x @ w."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    H, KVH = c["num_attention_heads"], c["num_key_value_heads"]
    D = c.get("head_dim") or d // H
    f = c["intermediate_size"]
    vp = -(-c["vocab_size"] // 256) * 256
    out = {"embed": (vp, d), "final_norm": (d,),
           "blocks": {"0": {"norm1": (L, d), "wq": (L, d, H * D),
                            "wk": (L, d, KVH * D), "wv": (L, d, KVH * D),
                            "wo": (L, H * D, d), "norm2": (L, d),
                            "ffn": {"wi": (L, d, f), "wg": (L, d, f),
                                    "wo": (L, f, d)}}}}
    if not c.get("tie_word_embeddings", False):
        out["unembed"] = (vp, d)
    return out


def make_weights(c: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Seeded weights on ``device``, one generator call a stacked leaf:
    norm scales one (fp32), every matrix normal with std 1/sqrt(fan_in)
    (fan_in the second-to-last dim) in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(name, shape):
        if name.startswith("norm") or name == "final_norm":
            return torch.ones(shape, dtype=torch.float32, device=device)
        w = torch.empty(shape, dtype=dtype, device=device)
        return w.normal_(0.0, 1.0 / math.sqrt(shape[-2]), generator=gen)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in tree.items()}

    return walk(layout(c))
