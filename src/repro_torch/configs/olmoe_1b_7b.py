"""OLMoE-1B-7B [arXiv:2409.02060] — MoE, 64 experts top-8, MHA."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50_304, head_dim=128,
    n_experts=64, top_k=8, d_expert=1024,
)
