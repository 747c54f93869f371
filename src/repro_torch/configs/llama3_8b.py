"""LLaMA3-8B — the paper's own evaluation model [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    mlp_type="swiglu", rope_type="standard", rope_theta=5e5,
    long_context_window=4096,
    source="arXiv:2407.21783",
)
