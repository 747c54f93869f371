"""Jamba-1.5-Large (398B) — hybrid Mamba+attention 1:7 with MoE
[arXiv:2403.19887].

Period-8 block: attention at in-block offset 4 (Jamba's attn_layer_offset),
Mamba elsewhere; MoE (16 experts, top-2) every other layer.  The original
uses the Mamba-1 selective scan; the reference implements the Mamba-2 SSD
formulation (same recurrence family, chunked scan), and the port keeps it.
"""
from repro_torch.models.config import (LayerSpec, ModelConfig, MoEConfig,
                                       SSMConfig)

_PATTERN = tuple(
    LayerSpec(mixer=("attn" if i == 4 else "mamba"),
              ffn=("moe" if i % 2 == 1 else "dense"))
    for i in range(8))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    pattern=_PATTERN,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, ngroups=1),
    mlp_type="swiglu", rope_type="none",   # Jamba uses no positional encoding
    source="arXiv:2403.19887",
)
