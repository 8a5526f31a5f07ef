"""SeamlessM4T-medium [arXiv:2308.11596; backbone only] — enc-dec, audio.

The speech frontend (fbank + w2v-BERT feature extractor) is a STUB:
input_specs() provides precomputed frame embeddings for the encoder.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256_206, head_dim=64, n_encoder_layers=12, cross_attention=True,
    frontend="audio", frontend_tokens=1024,
)
