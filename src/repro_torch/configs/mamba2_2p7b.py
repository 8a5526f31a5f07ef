"""Mamba2-2.7B [arXiv:2405.21060] — SSD (state-space duality), attention-free."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50_280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256, conv_width=4,
)
