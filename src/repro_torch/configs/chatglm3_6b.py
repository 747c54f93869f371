"""ChatGLM3-6B — dense GQA (kv=2) with 2D/partial RoPE [arXiv:2406.12793]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    mlp_type="swiglu", rope_type="partial", partial_rotary_factor=0.5,
    rope_theta=1e4, qkv_bias=True, long_context_window=4096,
    source="arXiv:2406.12793",
)
