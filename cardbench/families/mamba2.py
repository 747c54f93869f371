"""A Mamba-2 configuration (SSD mixer blocks, no FFN, tied embedding) on
the port's side: the port's ``ModelConfig`` from the configuration file,
and the seeded weights in the port's parameter layout.  The plain
reference of the same architecture is ``cardbench/refs/mamba2.py``."""

from __future__ import annotations

import math

import torch

REF = "mamba2"


def _sizes(c: dict) -> tuple:
    d = c["d_model"]
    d_in = c["expand"] * d
    H = d_in // c["headdim"]
    conv_ch = d_in + 2 * c["ngroups"] * c["d_state"]
    return d, d_in, H, conv_ch


def port_config(c: dict, dtype: str = "bfloat16"):
    """The port's ModelConfig of the file ``c`` (its own key names)."""
    from repro_torch.models.config import LayerSpec, ModelConfig, SSMConfig
    if c.get("d_intermediate", 0) or c.get("attn_layer_idx"):
        raise ValueError(f"{c['name']}: only pure Mamba-2 blocks")
    return ModelConfig(
        name=c["name"], family="ssm", n_layers=c["n_layer"],
        d_model=c["d_model"], n_heads=1, n_kv_heads=1, d_ff=0,
        vocab_size=c["vocab_size"],
        pattern=(LayerSpec(mixer="mamba", ffn="none"),),
        ssm=SSMConfig(d_state=c["d_state"], d_conv=c["d_conv"],
                      expand=c["expand"], head_dim=c["headdim"],
                      chunk_size=c["chunk_size"], ngroups=c["ngroups"]),
        rope_type="none", tie_embeddings=bool(c["tie_embeddings"]),
        norm_eps=float(c["norm_epsilon"]), dtype=dtype, source=c["source"])


def layout(c: dict) -> dict:
    """The weight tree's shapes, in the port's layout: ``embed`` (the
    vocabulary rounded up to 256 rows; tied) and one stacked block."""
    d, d_in, H, ch = _sizes(c)
    L, K = c["n_layer"], c["d_conv"]
    vp = -(-c["vocab_size"] // 256) * 256
    out = {"embed": (vp, d), "final_norm": (d,),
           "blocks": {"0": {"norm1": (L, d), "wz": (L, d, d_in),
                            "wxbc": (L, d, ch), "wdt": (L, d, H),
                            "dt_bias": (L, H), "A_log": (L, H), "D": (L, H),
                            "conv_w": (L, K, ch), "conv_b": (L, ch),
                            "norm": (L, d_in), "wout": (L, d_in, d)}}}
    if not c["tie_embeddings"]:
        out["unembed"] = (vp, d)
    return out


def make_weights(c: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Seeded weights on ``device``, one generator call a stacked leaf:
    norm scales and ``D`` one, ``conv_b`` zero, ``dt_bias`` so that
    softplus(dt_bias) spans [1e-3, 1e-1] log-uniformly, ``A_log =
    log(U(1, 16))`` (fp32, as mamba_ssm initialises them), every matrix
    normal with std 1/sqrt(fan_in) in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32

    def uniform(shape, lo, hi):
        return torch.empty(shape, dtype=f32, device=device).uniform_(
            lo, hi, generator=gen)

    def leaf(name, shape):
        if name == "dt_bias":
            dt = torch.exp(uniform(shape, math.log(1e-3), math.log(1e-1)))
            return dt + torch.log(-torch.expm1(-dt))     # softplus^-1
        if name == "A_log":
            return torch.log(uniform(shape, 1.0, 16.0))
        if name.startswith("norm") or name in ("final_norm", "D"):
            return torch.ones(shape, dtype=f32, device=device)
        if name == "conv_b":
            return torch.zeros(shape, dtype=dtype, device=device)
        w = torch.empty(shape, dtype=dtype, device=device)
        return w.normal_(0.0, 1.0 / math.sqrt(shape[-2]), generator=gen)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in tree.items()}

    return walk(layout(c))
