"""Model / shape configuration dataclasses.

Every assigned architecture is expressed as a :class:`ModelConfig`; the four
assigned input shapes are :class:`ShapeConfig` instances. ``reduced()``
produces the small same-family config used by CPU tests. Same fields,
defaults and reductions as the reference's ``configs/base.py``, plus the
fields of the port's own Nemotron-H family (``ssm_heads`` to
``experts_held``), whose defaults leave every other config as the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | encdec
                                  # | nemotron_h
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0             # per-expert FFN width
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512     # GShard dispatch group size (tokens)
    moe_impl: str = "einsum"      # einsum (GShard baseline) | gather (opt)
    router_aux_weight: float = 0.01
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    ssm_heads: int = 0            # 0 -> d_inner // ssm_head_dim, d_inner
                                  # = ssm_expand * d_model; else the heads
                                  # set d_inner = ssm_heads * ssm_head_dim
    ssm_groups: int = 1           # B/C groups; head i reads group
                                  # i // (heads / groups)
    ssm_norm: str = "norm_gate"   # norm_gate: rmsnorm over d_inner, then
                                  # times silu(z); gate_norm: times silu(z),
                                  # then rmsnorm over each group's channels
    # --- Mamba-2 / attention / MoE in one stack (Nemotron-H) ---
    layer_pattern: str = ""       # one mixer a layer: M (Mamba-2), E
                                  # (MoE), * (attention); "" = the family's
    use_rope: bool = True         # rotary embedding on self-attention
    routed_scaling: float = 1.0   # the chosen sigmoid weights' scale
    d_shared_expert: int = 0      # width of the always-on shared expert
    experts_held: int = 0         # routed experts on this device (0: all);
                                  # it holds experts 0 .. experts_held - 1
    # --- hybrid (RecurrentGemma) ---
    attn_window: int = 0          # local attention window (0 = full/global)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    rglru_d_rnn: int = 0          # recurrence width (0 -> d_model)
    # --- encoder-decoder ---
    n_encoder_layers: int = 0
    cross_attention: bool = False
    # --- modality frontend stubs ---
    frontend: str = "none"        # none | vision | audio
    frontend_tokens: int = 0      # embeddings provided by the stub per sample
    # --- pipeline parallelism (optional; pod axis = stages) ---
    pipeline_stages: int = 0      # 0/1 = off
    pipeline_microbatches: int = 8
    # --- loss ---
    chunked_xent: bool = False    # never materialize [B,S,V] logits
    # --- numerics / structure ---
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    use_kernels: bool = False     # kernel branches (CUDA on the card; their
                                  # plain versions on the CPU)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_held(self) -> int:
        """Routed experts this device holds (the first ``n_held``)."""
        return self.experts_held or self.n_experts

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        dtype="float32",
        remat=False,
        scan_layers=cfg.scan_layers,
    )
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=2, d_expert=64, moe_group_size=64)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16, d_model=64,
                  n_heads=2, n_kv_heads=2, head_dim=32)
    if cfg.family == "hybrid":
        kw.update(attn_window=16, block_pattern=("rec", "rec", "attn"),
                  n_layers=3, rglru_d_rnn=0)
    if cfg.family == "nemotron_h":
        # every kind of layer twice, 2 B/C groups, 4 of 8 experts held
        kw.update(layer_pattern="ME*EM*", n_layers=6, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, ssm_heads=4,
                  ssm_head_dim=16, ssm_groups=2, ssm_state=16, ssm_chunk=16,
                  n_experts=8, top_k=2, experts_held=4, d_expert=32,
                  d_shared_expert=48)
    if cfg.family == "encdec":
        kw.update(n_encoder_layers=2)
    if cfg.frontend != "none":
        kw.update(frontend_tokens=8)
    return cfg.with_(**kw)
