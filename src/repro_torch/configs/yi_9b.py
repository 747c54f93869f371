"""Yi-9B — llama-arch dense GQA [arXiv:2403.04652]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    mlp_type="swiglu", rope_type="standard", rope_theta=5e6,
    long_context_window=4096,   # beyond-paper SWA used only for long_500k
    source="arXiv:2403.04652",
)
