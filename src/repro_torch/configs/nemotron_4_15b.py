"""Nemotron-4-15B — dense GQA with squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab_size=256000,
    mlp_type="relu2", rope_type="standard", rope_theta=1e4,
    long_context_window=4096,
    source="arXiv:2402.16819",
)
