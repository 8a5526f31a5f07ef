"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — MoE, 128 experts top-8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab=151_936, head_dim=128, rope_theta=1e6,
    n_experts=128, top_k=8, d_expert=768,
)
