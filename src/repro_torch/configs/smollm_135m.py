"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small dense LM."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49_152, head_dim=64, tie_embeddings=True,
)
