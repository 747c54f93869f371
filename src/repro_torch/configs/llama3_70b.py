"""LLaMA3-70B — the paper's own evaluation model [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-70b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    mlp_type="swiglu", rope_type="standard", rope_theta=5e5,
    long_context_window=4096,
    source="arXiv:2407.21783",
)
