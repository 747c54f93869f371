"""Qwen2-VL-72B — VLM language backbone with M-RoPE [arXiv:2409.12191].

Backbone only: the ViT vision encoder + projector are stubbed —
``input_specs`` provides token ids plus (3, B, S) M-RoPE position ids
(temporal / height / width); patch embeddings are pre-merged by the stubbed
frontend (DESIGN.md §VLM shape conventions).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    mlp_type="swiglu", rope_type="mrope", rope_theta=1e6,
    mrope_sections=(16, 24, 24), qkv_bias=True,
    long_context_window=4096,
    source="arXiv:2409.12191",
)
