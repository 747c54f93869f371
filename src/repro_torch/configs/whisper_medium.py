"""Whisper-medium — encoder-decoder audio backbone [arXiv:2212.04356].

Transformer backbone only: the mel-spectrogram + conv frontend is stubbed —
``input_specs`` provides precomputed frame embeddings (B, S, d_model) for the
encoder (DESIGN.md §Whisper shape conventions).  MHA (n_kv == n_heads),
learned positional embeddings, GELU MLP, attention biases.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    pattern=(LayerSpec(mixer="attn", ffn="dense", cross_attn=True),),
    encoder_decoder=True, n_encoder_layers=24, cross_kv_len=1500,
    mlp_type="gelu", rope_type="none", pos_embedding="learned",
    qkv_bias=True, max_position=1 << 16,
    source="arXiv:2212.04356",
)
