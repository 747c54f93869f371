"""Mamba2-1.3B — attention-free SSD (state-space duality) [arXiv:2405.21060].

Pure mamba blocks (no FFN), d_inner = 2*d_model = 4096, 64 SSD heads of
width 64, state size 128.
"""
from repro_torch.models.config import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280,
    pattern=(LayerSpec(mixer="mamba", ffn="none"),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, ngroups=1),
    rope_type="none", tie_embeddings=True,
    source="arXiv:2405.21060",
)
