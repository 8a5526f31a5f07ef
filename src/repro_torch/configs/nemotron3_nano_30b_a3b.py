"""NVIDIA Nemotron-3-Nano-30B-A3B [hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16;
family paper arXiv:2504.03624] — 52 single-mixer blocks: 23 Mamba-2 (64
heads of 64, 8 B/C groups, state 128), 23 sigmoid-routed MoE (128 experts of
1,856, top 6, relu², one shared expert of 3,712) and 6 GQA attention layers
without rotary embedding (32 query and 2 KV heads of 128).

``CONFIG`` is the published model, every expert held. ``EP8`` is one card's
share of its stated deployment, expert parallelism over 8 cards: the card
holds experts 0-15 of every MoE layer (the router still scores all 128 and
picks the top 6), every other weight whole."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-3-nano-30b-a3b", family="nemotron_h",
    n_layers=52, d_model=2688, n_heads=32, n_kv_heads=2, d_ff=1856,
    vocab=131_072, head_dim=128, tie_embeddings=False, norm_eps=1e-5,
    layer_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    use_rope=False,
    ssm_state=128, ssm_head_dim=64, ssm_heads=64, ssm_groups=8,
    ssm_chunk=128, conv_width=4, ssm_norm="gate_norm",
    n_experts=128, top_k=6, d_expert=1856, routed_scaling=2.5,
    d_shared_expert=3712,
)

#: One card of expert parallelism over 8: experts 0-15 of each MoE layer.
EP8 = CONFIG.with_(arch_id="nemotron-3-nano-30b-a3b-ep8", experts_held=16)
