"""Dense decoder-only transformer (the llama/Qwen family). The port of the
dense entries of ``repro/models/transformer.py``.

Each block: rmsnorm, GQA self-attention with RoPE (and QKV biases where the
config has them), residual; rmsnorm, SwiGLU MLP, residual. The reference's
stacked ``[n_layers, ...]`` block parameters are unrolled into a
``ModuleList``, and the KV cache holds one ``[B, max_len, Hkv, hd]`` pair
per layer (``layers.make_cache``), written in place.

  * over a full sequence (``forward``) attention goes through
    ``kernels.ops.flash_attention`` under the reference's kernel condition;
  * the prompt pass (``prefill``) and each decode step attend through the
    cache branch of ``layers.attention_apply``, as in the reference: with
    ``use_kernels``, the prefill through ``flash_attention`` and each decode
    step through ``kernels.ops.decode_attention`` (the CUDA kernels on the
    card), else the plain ``_sdpa`` over the cache.

The unembedding is tied to the embedding table (``tie_embeddings``, e.g.
SmolLM) or a separate ``head`` (Qwen2). The VLM frontend (``embeds``) and
the encoder-decoder entries are not ported: ``model.Model`` raises for
them.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L

__all__ = ["DenseBlock", "DenseParams", "init", "block_apply", "forward",
           "prefill", "decode_step"]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model)
        self.attn = L.Attention(cfg)
        self.ln2 = L.RMSNorm(cfg.d_model)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff)

    def init_(self, gen: torch.Generator) -> None:
        self.attn.init_(gen)
        self.mlp.init_(gen)


class DenseParams(nn.Module):
    """The whole model's parameters: ``embed``, ``layers`` (one
    :class:`DenseBlock` per layer), ``ln_f`` and, when the unembedding is
    not tied, ``head``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab, cfg.d_model)
        self.layers = nn.ModuleList(DenseBlock(cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model)
        if not cfg.tie_embeddings:
            self.head = L.Linear(cfg.d_model, cfg.vocab)


def init(cfg: ModelConfig, seed: int = 0, device=None) -> DenseParams:
    """Random parameters from ``seed`` with the reference's distributions
    (normal / sqrt(fan_in) for linear weights and the head, 0.02 for the
    embedding, zero QKV biases, unit norm scales), made on ``device`` in
    fp32. A ``torch.Generator`` does not give ``jax.random``'s numbers:
    tests carry the reference's weights across through
    ``interop.model_params_from_numpy``."""
    device = resolve_device(device)
    with torch.device("meta"):
        p = DenseParams(cfg)
    p = p.to_empty(device=device).requires_grad_(False)
    with torch.no_grad():
        for name, t in p.named_parameters():
            if name.endswith(".b"):
                t.zero_()
            elif name.endswith(".scale"):
                t.fill_(1.0)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    p.embed.init_(gen)
    for lp in p.layers:
        lp.init_(gen)
    if not cfg.tie_embeddings:
        p.head.init_(gen)
    return p


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def block_apply(cfg: ModelConfig, p: DenseBlock, x, positions, cache=None):
    """One block with its residuals; ``cache`` (one layer's ``k``, ``v``
    and ``pos``) is written in place."""
    x = x + L.attention_apply(p.attn, cfg, L.rmsnorm(p.ln1, x, cfg.norm_eps),
                              positions, cache=cache)
    return x + L.mlp_apply(p.mlp, L.rmsnorm(p.ln2, x, cfg.norm_eps))


def _logits(cfg: ModelConfig, params: DenseParams, x):
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params.embed, x)
    return L.linear(params.head, x)


def forward(cfg: ModelConfig, params: DenseParams, tokens):
    """Full-sequence causal logits [B, S, vocab] in the activation dtype."""
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp in params.layers:
        x = block_apply(cfg, lp, x, positions)
    return _logits(cfg, params, x)


def prefill(cfg: ModelConfig, params: DenseParams, tokens,
            max_len: int = 0):
    """Prompt pass: last-token logits [B, 1, vocab] and a KV cache of
    capacity ``max_len`` (0: the prompt's length) holding the prompt's keys
    and values, ``pos`` = S."""
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    B, S, _ = x.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"prefill: max_len {max_len} < prompt length {S}")
    cache = L.make_cache(cfg, B, max_len, cfg.n_layers, x.dtype, x.device)
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp, ck, cv in zip(params.layers, cache["k"], cache["v"]):
        x = block_apply(cfg, lp, x, positions,
                        cache={"k": ck, "v": cv, "pos": 0})
    cache["pos"] = S
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: DenseParams, token, cache: Dict):
    """One token per sequence (``token`` [B]) against the cache -> (logits
    [B, vocab], the cache with ``pos`` advanced). The cache's tensors are
    written in place: the returned cache shares them with ``cache``."""
    x = L.embed(params.embed, token[:, None], L.compute_dtype(cfg))
    B = x.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    for lp, ck, cv in zip(params.layers, cache["k"], cache["v"]):
        x = block_apply(cfg, lp, x, positions,
                        cache={"k": ck, "v": cv, "pos": pos})
    logits = _logits(cfg, params, x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
