"""DeepSeek-67B [arXiv:2401.02954] — llama-arch dense GQA, 95 layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22_016,
    vocab=102_400, head_dim=128,
)
