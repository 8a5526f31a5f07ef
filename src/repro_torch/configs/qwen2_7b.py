"""Qwen2-7B [arXiv:2407.10671] — dense GQA with QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18_944,
    vocab=152_064, head_dim=128, qkv_bias=True, rope_theta=1e6,
)
