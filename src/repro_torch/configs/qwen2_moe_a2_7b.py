"""Qwen1.5/2-MoE-A2.7B — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared=4, d_shared=1408),
    mlp_type="swiglu", rope_type="standard", rope_theta=1e6,
    qkv_bias=True, long_context_window=4096,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
