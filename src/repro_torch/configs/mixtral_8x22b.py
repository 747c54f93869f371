"""Mixtral-8x22B — MoE (8 experts, top-2) with sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384),
    mlp_type="swiglu", rope_type="standard", rope_theta=1e6,
    sliding_window=4096,        # native SWA -> long_500k runs natively
    source="arXiv:2401.04088",
)
