"""Phi-4-mini-3.8B — dense RoPE/SwiGLU/GQA [arXiv:2412.08905].

24 query heads do not divide the 16-way model axis; heads are padded to 32
with inert zero heads (see ModelConfig.pad_heads_to and DESIGN.md §4) — the
~33% attention-FLOP overhead for this arch is reported in the roofline.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200064,
    mlp_type="swiglu", rope_type="standard", rope_theta=1e4,
    pad_heads_to=32, long_context_window=4096,
    source="arXiv:2412.08905",
)
