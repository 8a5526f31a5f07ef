"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6; backbone only] — VLM.

The anyres vision tower is a STUB: input_specs() provides precomputed patch
embeddings (anyres tiling of a 672x672 image -> 2880 patch tokens) that the
backbone consumes alongside text tokens.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20_480,
    vocab=64_000, head_dim=128, rope_theta=5e6,
    frontend="vision", frontend_tokens=2880,
)
