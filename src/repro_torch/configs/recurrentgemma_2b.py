"""RecurrentGemma-2B [arXiv:2402.19427] — RG-LRU + local attention, 1:2."""
from .base import ModelConfig

# 26 layers, repeating (recurrent, recurrent, local-attention); MQA (kv=1),
# local window 2048, head_dim 256, d_rnn = lru_width 2560.
CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256_000, head_dim=256, attn_window=2048,
    block_pattern=("rec", "rec", "attn"), rglru_d_rnn=2560,
)
